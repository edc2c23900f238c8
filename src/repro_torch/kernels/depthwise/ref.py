"""Plain eager oracle of the depthwise conv (NHWC): the `ref` route, a
grouped `conv2d` in float32 (TF32 off, as the package sets it)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["depthwise_ref"]


def depthwise_ref(x: torch.Tensor, filt: torch.Tensor, stride: int = 1,
                  padding: str = "SAME") -> torch.Tensor:
    """x: (N, H, W, C); filt: (kh, kw, C) -> (N, H_out, W_out, C).
    padding "SAME" (TensorFlow's rule: the extra pad row/column goes after)
    or "VALID"."""
    kh, kw, c = filt.shape
    xc = x.to(torch.float32).permute(0, 3, 1, 2)          # NCHW
    if padding == "SAME":
        pads = []
        for size, k in ((x.shape[2], kw), (x.shape[1], kh)):
            total = max((-(-size // stride) - 1) * stride + k - size, 0)
            pads += [total // 2, total - total // 2]
        xc = F.pad(xc, pads)
    elif padding != "VALID":
        raise ValueError(f"padding {padding!r} not in ('SAME', 'VALID')")
    wt = filt.to(torch.float32).permute(2, 0, 1).unsqueeze(1)  # (C,1,kh,kw)
    out = F.conv2d(xc, wt, stride=stride, groups=c)
    return out.permute(0, 2, 3, 1).to(x.dtype)
