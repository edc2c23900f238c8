"""Workload extraction: the paper's seven AI benchmarks as layer-op lists.

Each op is the GEMM view the paper's (SCALE-sim-derived) simulator uses:
input {S_C, T} x weight {T, S_R}, plus the op class (Table I). Convs are
im2col'ed (footnote 5); depthwise convs and conv weight-gradients are
UNACCUMULABLE (no C_in reduction); GEMM weight-gradients reduce over B*L so
they stay accumulable — which is exactly why Fig 14 shows ~100% LLM
utilization but a WG-step cliff for CNNs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

__all__ = ["Op", "training_ops", "inference_ops", "MODELS", "llm_ops"]


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    kind: str          # 'conv' | 'depthwise' | 'fc' | 'gemm' | '*_wg'
    s_c: int           # streamed input rows (B * H_out * W_out or B * L)
    t: int             # contraction (C_in*K^2, d_model, ...)
    s_r: int           # output columns (C_out, d_ff, ...)
    taps: int = 0      # K^2 for convs (unaccumulable mapping parameter)
    channels: int = 0  # channel count for depthwise
    repeat: int = 1    # identical-shape instances (e.g. per-head GEMMs)

    @property
    def macs(self) -> int:
        if self.kind.startswith("depthwise"):
            per = self.s_c * self.taps * self.channels
        else:
            per = self.s_c * self.t * self.s_r
        return per * self.repeat


def conv(name, b, h_out, w_out, c_in, c_out, k, stride=1) -> Op:
    return Op(name, "conv", b * h_out * w_out, c_in * k * k, c_out, taps=k * k)


def dwconv(name, b, h_out, w_out, c, k) -> Op:
    return Op(name, "depthwise", b * h_out * w_out, k * k, c, taps=k * k,
              channels=c)


def fc(name, b, d_in, d_out) -> Op:
    return Op(name, "fc", b, d_in, d_out)


def gemm(name, m, k, n) -> Op:
    return Op(name, "gemm", m, k, n)


# =============================================================================
# CNNs (ImageNet 224x224, batch B)
# =============================================================================

def vgg16(b: int) -> List[Op]:
    cfg = [(224, 3, 64), (224, 64, 64), (112, 64, 128), (112, 128, 128),
           (56, 128, 256), (56, 256, 256), (56, 256, 256),
           (28, 256, 512), (28, 512, 512), (28, 512, 512),
           (14, 512, 512), (14, 512, 512), (14, 512, 512)]
    ops = [conv(f"conv{i}", b, hw, hw, ci, co, 3)
           for i, (hw, ci, co) in enumerate(cfg)]
    ops += [fc("fc1", b, 25088, 4096), fc("fc2", b, 4096, 4096),
            fc("fc3", b, 4096, 1000)]
    return ops


def resnet18(b: int) -> List[Op]:
    ops = [conv("stem", b, 112, 112, 3, 64, 7, 2)]
    stages = [(56, 64, 64, 2), (28, 64, 128, 2), (14, 128, 256, 2),
              (7, 256, 512, 2)]
    for si, (hw, c_in, c_out, blocks) in enumerate(stages):
        for bi in range(blocks):
            ci = c_in if bi == 0 else c_out
            ops.append(conv(f"s{si}b{bi}c1", b, hw, hw, ci, c_out, 3))
            ops.append(conv(f"s{si}b{bi}c2", b, hw, hw, c_out, c_out, 3))
            if bi == 0 and ci != c_out:
                ops.append(conv(f"s{si}b{bi}sc", b, hw, hw, ci, c_out, 1))
    ops.append(fc("fc", b, 512, 1000))
    return ops


def mobilenet_v2(b: int) -> List[Op]:
    """Inverted residual blocks (expansion 1x1 -> 3x3 dw -> projection 1x1)."""
    ops = [conv("stem", b, 112, 112, 3, 32, 3, 2)]
    # (t, c_out, n, stride, hw_in)
    blocks = [(1, 16, 1, 1, 112), (6, 24, 2, 2, 112), (6, 32, 3, 2, 56),
              (6, 64, 4, 2, 28), (6, 96, 3, 1, 14), (6, 160, 3, 2, 14),
              (6, 320, 1, 1, 7)]
    c_in = 32
    for bi, (t, c_out, n, stride, hw_in) in enumerate(blocks):
        for i in range(n):
            s = stride if i == 0 else 1
            hw_o = hw_in // s
            d = c_in * t
            if t != 1:
                ops.append(conv(f"b{bi}_{i}exp", b, hw_in, hw_in, c_in, d, 1))
            ops.append(dwconv(f"b{bi}_{i}dw", b, hw_o, hw_o, d, 3))
            ops.append(conv(f"b{bi}_{i}proj", b, hw_o, hw_o, d, c_out, 1))
            c_in = c_out
            hw_in = hw_o
    ops.append(conv("head", b, 7, 7, 320, 1280, 1))
    ops.append(fc("fc", b, 1280, 1000))
    return ops


def efficientnet_b0(b: int) -> List[Op]:
    """MBConv blocks (expansion, k x k depthwise, SE skipped, projection)."""
    ops = [conv("stem", b, 112, 112, 3, 32, 3, 2)]
    # (expand, c_out, n, stride, k, hw_in)
    blocks = [(1, 16, 1, 1, 3, 112), (6, 24, 2, 2, 3, 112),
              (6, 40, 2, 2, 5, 56), (6, 80, 3, 2, 3, 28),
              (6, 112, 3, 1, 5, 14), (6, 192, 4, 2, 5, 14),
              (6, 320, 1, 1, 3, 7)]
    c_in = 32
    for bi, (t, c_out, n, stride, k, hw_in) in enumerate(blocks):
        for i in range(n):
            s = stride if i == 0 else 1
            hw_o = hw_in // s
            d = c_in * t
            if t != 1:
                ops.append(conv(f"b{bi}_{i}exp", b, hw_in, hw_in, c_in, d, 1))
            ops.append(dwconv(f"b{bi}_{i}dw", b, hw_o, hw_o, d, k))
            ops.append(conv(f"b{bi}_{i}proj", b, hw_o, hw_o, d, c_out, 1))
            c_in = c_out
            hw_in = hw_o
    ops.append(conv("head", b, 7, 7, 320, 1280, 1))
    ops.append(fc("fc", b, 1280, 1000))
    return ops


def convnext_s(b: int) -> List[Op]:
    """ConvNeXt-S: stages [3,3,27,3], dims [96,192,384,768], 7x7 depthwise +
    pointwise MLP (4x)."""
    ops = [conv("stem", b, 56, 56, 3, 96, 4, 4)]
    dims = [96, 192, 384, 768]
    depths = [3, 3, 27, 3]
    hw = 56
    for si, (dim, depth) in enumerate(zip(dims, depths)):
        if si > 0:
            ops.append(conv(f"s{si}down", b, hw // 2, hw // 2, dims[si - 1],
                            dim, 2, 2))
            hw //= 2
        for i in range(depth):
            ops.append(dwconv(f"s{si}b{i}dw", b, hw, hw, dim, 7))
            ops.append(conv(f"s{si}b{i}pw1", b, hw, hw, dim, 4 * dim, 1))
            ops.append(conv(f"s{si}b{i}pw2", b, hw, hw, 4 * dim, dim, 1))
    ops.append(fc("fc", b, 768, 1000))
    return ops


# =============================================================================
# LLMs — the paper's setting: L=512, d_model=4096, d_head=128, B*L=4096
# =============================================================================

def llm_ops(b: int, l: int, d_model: int, d_ff: int, n_layers: int,
            d_head: int = 128, name: str = "llm") -> List[Op]:
    bl = b * l
    n_heads = d_model // d_head
    ops: List[Op] = []
    for i in range(n_layers):
        ops.append(gemm(f"l{i}.qkv", bl, d_model, 3 * d_model))
        # per-head attention GEMMs (paper: per-head K/Q/V are R^{4096 x 128})
        ops.append(Op(f"l{i}.scores", "gemm", bl, d_head, l, repeat=n_heads))
        ops.append(Op(f"l{i}.attnv", "gemm", bl, l, d_head, repeat=n_heads))
        ops.append(gemm(f"l{i}.proj", bl, d_model, d_model))
        ops.append(gemm(f"l{i}.ff1", bl, d_model, d_ff))
        ops.append(gemm(f"l{i}.ff2", bl, d_ff, d_model))
    return ops


def gpt2_small(b: int) -> List[Op]:
    return llm_ops(b, 512, 768, 3072, 12, d_head=64, name="gpt2")


def llama2_7b(b: int) -> List[Op]:
    return llm_ops(b, 512, 4096, 11008, 32, d_head=128, name="llama2")


# transformer for the image-captioning tenant (§VI-C) — a small NLP decoder
def captioning_transformer(b: int) -> List[Op]:
    return llm_ops(b, 196, 512, 2048, 6, d_head=64, name="captioner")


MODELS: Dict[str, Callable[[int], List[Op]]] = {
    "vgg16": vgg16,
    "resnet18": resnet18,
    "mobilenetv2": mobilenet_v2,
    "efficientnet_b0": efficientnet_b0,
    "convnext_s": convnext_s,
    "gpt2": gpt2_small,
    "llama2_7b": llama2_7b,
    "captioner": captioning_transformer,
}


# =============================================================================
# Training-step expansion (FW / BW / WG) per Table I
# =============================================================================

def training_ops(model: str, b: int) -> Dict[str, List[Op]]:
    """FW: as listed. BW (dL/dx): accumulable, contraction flips to S_R.
    WG (dL/dW): conv -> UNACCUMULABLE (taps = K^2); fc/gemm -> accumulable
    with T = batch rows."""
    fw = MODELS[model](b)
    bw: List[Op] = []
    wg: List[Op] = []
    for op in fw:
        if op.kind == "conv":
            bw.append(Op(op.name + ".dx", "conv", op.s_c, op.s_r * op.taps,
                         op.t // op.taps, taps=op.taps))
            # dW: outputs (T x S_R), reduction over S_C — unaccumulable class
            wg.append(Op(op.name + ".dw", "conv_wg", op.s_c, op.t, op.s_r,
                         taps=op.taps, channels=(op.t // op.taps) * op.s_r))
        elif op.kind == "depthwise":
            bw.append(Op(op.name + ".dx", "depthwise", op.s_c, op.taps,
                         op.channels, taps=op.taps, channels=op.channels))
            wg.append(Op(op.name + ".dw", "depthwise_wg", op.s_c, op.taps,
                         op.channels, taps=op.taps, channels=op.channels))
        else:  # fc / gemm: dX = dY W^T ; dW = X^T dY (both accumulable)
            bw.append(Op(op.name + ".dx", op.kind, op.s_c, op.s_r, op.t))
            wg.append(Op(op.name + ".dw", op.kind, op.t, op.s_c, op.s_r))
    return {"FW": fw, "BW": bw, "WG": wg}


def inference_ops(model: str, b: int) -> List[Op]:
    return MODELS[model](b)
