#!/usr/bin/env python3
"""How far the step recurrence drifts from the full-sequence forward with
depth: `decode_step` token by token (one row, float32 caches) against
`forward` on the same tokens, for a config at its full width cut to a few
depths.

    python3 scripts/teacher_forced_gap.py --arch xlstm_1p3b \
        --layers 2,4,8 [--tokens 256] [--device cpu]

Random weights from seed 0, random tokens from seed 11 (those of
`chip_smoke.py` phase 5e's teacher-forced check, which runs the full
depth on the card). For each depth, prints max |dlogit| / max |logit| and
where along the sequence the largest gap sits. A recurrent config's depth
is cut in whole units of its layer pattern (xlstm: an sLSTM every
`slstm_every`-th layer, so a depth d makes `slstm_every` d; zamba2: the
shared block every `attn_every`-th). Runs on the card unless asked for the
CPU; at full width a depth of 8 needs ~3 GB.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.models import (decode_step, forward,  # noqa: E402
                                init_caches, init_params)


def cut(cfg, depth: int):
    """`cfg` at `depth` layers, the recurrent pattern's period set to it
    (one sLSTM or one shared-block invocation, last)."""
    kw = {"n_layers": depth}
    for period in ("slstm_every", "attn_every"):
        if getattr(cfg, period):
            kw[period] = depth
    return dataclasses.replace(cfg, **kw)


@torch.no_grad()
def gap(cfg, tokens: int, device) -> tuple:
    model = init_params(cfg, seed=0, device=device)
    toks = torch.from_numpy(np.random.RandomState(11).randint(
        1, cfg.vocab, (1, tokens))).to(device)
    full, _ = forward(model, toks)
    caches = init_caches(cfg, 1, tokens, device=device, dtype=torch.float32)
    steps = torch.stack([decode_step(model, caches, toks[:, t:t + 1])[0][:, 0]
                         for t in range(tokens)], dim=1)
    per_pos = (steps - full).abs().amax(-1)[0]
    return (per_pos.max() / full.abs().max()).item(), int(per_pos.argmax())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm_1p3b", choices=ARCH_IDS)
    ap.add_argument("--layers", default="2,4,8")
    ap.add_argument("--tokens", type=int, default=256)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    base = get_config(args.arch)
    if args.device == "cuda":
        print(torch.cuda.get_device_name(0))
    for depth in (int(x) for x in args.layers.split(",")):
        rel, at = gap(cut(base, depth), args.tokens, torch.device(args.device))
        print(f"{args.arch} x{depth} layers, {args.tokens} tokens on "
              f"{args.device}: max |dlogit| / max |logit| {rel:.3e} "
              f"(largest at position {at})", flush=True)


if __name__ == "__main__":
    main()
