"""Recurrent blocks: Mamba2 (zamba2's backbone) and xLSTM's mLSTM and
sLSTM, with their per-row state caches.

One chunked gated linear recurrence serves Mamba2 and the mLSTM:

    S_t = exp(a_t) S_{t-1} + k_t (x) v_t       S: (P, S) per head
    y_t = q_t . S_t                            contracted over P

Mamba2's SSD maps as k := B, v := dt * x, q := C (the state transposed:
B rides the P slot), the mLSTM as k := i * key, v := value, q := query,
with its normalizer carried as an extra ones-column of v. `chunked_gla`
evaluates it over a whole sequence: within a chunk a masked decay product
(an attention-like chunk x chunk matrix), across chunks a scan of the
chunk summaries (a Python loop over the chunks); `gla_step` is the
one-token recurrence the cached path runs. The sLSTM is a sequential
exponentially gated scalar LSTM with block-diagonal recurrent weights.

The reference's deviations from the published models are kept: the
mLSTM's input gate is a sigmoid (no exponential-gate stabilizer) and
Mamba2 has one B/C group shared by its heads. The state math is float32.
The blocks' Linears take no QuantPolicy: the reference calls them without
one, so they stay dense under any policy and any residency format.

A cache is updated by REBINDING its fields to new tensors (never written
in place): a launch that fails part-way can then be undone by putting the
old references back, as the serving engine does with a KV cache's `pos`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from .layers import Linear, RMSNorm, _normal, rmsnorm

__all__ = ["chunked_gla", "gla_step", "causal_conv", "Mamba2", "MLSTM",
           "SLSTM", "MambaCache", "MLSTMCache", "SLSTMCache",
           "RECURRENT_TYPES", "SLSTM_M_INIT", "init_mamba_cache",
           "init_mlstm_cache", "init_slstm_cache", "cache_init_values",
           "where_rows"]

# the sLSTM stabilizer's initial value (the reference's -inf stand-in)
SLSTM_M_INIT = -1e30


# ============================================================ recurrence
def chunked_gla(a_log: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                q: torch.Tensor, chunk: int = 128,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """y_t = q_t . S_t with S_t = exp(a_log_t) S_{t-1} + k_t (x) v_t over a
    whole sequence. a_log: (B, L, H) log-decays (<= 0); k, q: (B, L, H, P);
    v: (B, L, H, S); init_state: (B, H, P, S) or None (zeros). Returns
    (y (B, L, H, S) float32, the final state (B, H, P, S) float32). L is
    right-padded to a multiple of `chunk` (a pad step has decay 1 and adds
    nothing)."""
    b, l, h, p = k.shape
    s = v.shape[-1]
    pad = (-l) % chunk
    if pad:
        a_log = F.pad(a_log, (0, 0, 0, pad))
        k, v, q = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (k, v, q))
    nc = (l + pad) // chunk
    a_c = a_log.reshape(b, nc, chunk, h).to(torch.float32)
    k_c, v_c, q_c = (t.reshape(b, nc, chunk, h, -1).to(torch.float32)
                     for t in (k, v, q))
    cum = torch.cumsum(a_c, dim=2)                         # (b, nc, q, h)
    total = cum[:, :, -1]                                  # (b, nc, h)

    # intra-chunk: the masked decay product
    scores = torch.einsum("bnihp,bnjhp->bnhij", q_c, k_c)
    dec = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).permute(
        0, 1, 4, 2, 3)                                     # (b, nc, h, i, j)
    mask = torch.ones(chunk, chunk, dtype=torch.bool,
                      device=k.device).tril()
    w = torch.where(mask, torch.exp(dec), torch.zeros((), device=k.device))
    y = torch.einsum("bnhij,bnjhs->bnihs", scores * w, v_c)

    # chunk summaries: S_n = sum_j exp(total - cum_j) k_j (x) v_j
    wk = torch.exp(total[:, :, None] - cum)                # (b, nc, q, h)
    s_chunk = torch.einsum("bnjhp,bnjhs->bnhps", k_c * wk[..., None], v_c)

    # inter-chunk scan: each chunk reads the state before it
    state = torch.zeros(b, h, p, s, dtype=torch.float32, device=k.device) \
        if init_state is None else init_state.to(torch.float32)
    prev = []
    for n in range(nc):
        prev.append(state)
        state = state * torch.exp(total[:, n])[..., None, None] \
            + s_chunk[:, n]
    prev_states = torch.stack(prev, dim=1)                 # (b, nc, h, p, s)
    y = y + torch.einsum("bnihp,bnhps->bnihs",
                         q_c * torch.exp(cum)[..., None], prev_states)
    return y.reshape(b, nc * chunk, h, s)[:, :l], state


def gla_step(state: torch.Tensor, a_log: torch.Tensor, k: torch.Tensor,
             v: torch.Tensor, q: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the recurrence. state: (B, H, P, S); a_log: (B, H);
    k, q: (B, H, P); v: (B, H, S) -> (y (B, H, S), the new state), both
    float32."""
    k, v, q = (t.to(torch.float32) for t in (k, v, q))
    new = state * torch.exp(a_log.to(torch.float32))[..., None, None] \
        + k[..., :, None] * v[..., None, :]
    y = torch.einsum("bhp,bhps->bhs", q, new)
    return y, new


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                cache: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x: (B, L, C); w: (W, C); cache: (B, W-1, C),
    the last W-1 inputs (zeros before the first), or None for a whole
    sequence. Returns (y (B, L, C), the new cache: the history's last W-1
    inputs, in x's dtype)."""
    width = w.shape[0]
    if cache is None:
        hist = F.pad(x, (0, 0, width - 1, 0))
    else:
        hist = torch.cat([cache.to(x.dtype), x], dim=1)
    y = torch.zeros_like(x)
    for i in range(width):
        y = y + hist[:, i:i + x.shape[1]] * w[i]
    return y, (hist[:, -(width - 1):] if width > 1 else None)


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0), with no linear cut-over
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _one_token(x: torch.Tensor, name: str) -> None:
    if x.shape[1] != 1:
        raise ValueError(f"{name}: a cached step takes one token a row, "
                         f"not {x.shape[1]}")


# ================================================================ caches
@dataclasses.dataclass
class MambaCache:
    """ssm: (B, H, S, P) float32, the transposed state (B rides the S
    slot); conv: (B, W-1, d_inner + 2 d_state) float32, the conv's last
    inputs."""
    ssm: torch.Tensor
    conv: torch.Tensor


@dataclasses.dataclass
class MLSTMCache:
    """state: (B, H, Dk, Dv + 1) float32, its last column the normalizer;
    conv: (B, W-1, d_inner) float32."""
    state: torch.Tensor
    conv: torch.Tensor


@dataclasses.dataclass
class SLSTMCache:
    """(B, D) float32 each: cell c, normalizer n, stabilizer m (starts at
    SLSTM_M_INIT), and h, the recurrent input."""
    c: torch.Tensor
    n: torch.Tensor
    m: torch.Tensor
    h: torch.Tensor


RECURRENT_TYPES = (MambaCache, MLSTMCache, SLSTMCache)


def _zeros(*shape, device):
    return torch.zeros(shape, dtype=torch.float32, device=device)


def init_mamba_cache(batch: int, d_model: int, *, d_state: int = 64,
                     expand: int = 2, headdim: int = 64,
                     conv_width: int = 4, device) -> MambaCache:
    d_inner = expand * d_model
    return MambaCache(
        ssm=_zeros(batch, d_inner // headdim, d_state, headdim,
                   device=device),
        conv=_zeros(batch, conv_width - 1, d_inner + 2 * d_state,
                    device=device))


def init_mlstm_cache(batch: int, d_model: int, *, n_heads: int = 4,
                     pf: float = 2.0, conv_width: int = 4,
                     device) -> MLSTMCache:
    d_inner = int(d_model * pf)
    dh = d_inner // n_heads
    return MLSTMCache(state=_zeros(batch, n_heads, dh, dh + 1, device=device),
                      conv=_zeros(batch, conv_width - 1, d_inner,
                                  device=device))


def init_slstm_cache(batch: int, d_model: int, *, device) -> SLSTMCache:
    return SLSTMCache(
        c=_zeros(batch, d_model, device=device),
        n=_zeros(batch, d_model, device=device),
        m=torch.full((batch, d_model), SLSTM_M_INIT, dtype=torch.float32,
                     device=device),
        h=_zeros(batch, d_model, device=device))


def where_rows(mask: torch.Tensor, new: torch.Tensor,
               old: torch.Tensor) -> torch.Tensor:
    """`new` on the rows (leading axis) where mask (B,) is True, `old`
    elsewhere: a new tensor."""
    return torch.where(mask.view((-1,) + (1,) * (old.dim() - 1)), new, old)


def cache_init_values(cache) -> dict:
    """{field: the value a fresh row of `cache` holds}: 0, and the sLSTM
    stabilizer's SLSTM_M_INIT."""
    return {f.name: SLSTM_M_INIT if (isinstance(cache, SLSTMCache)
                                     and f.name == "m") else 0.0
            for f in dataclasses.fields(cache)}


# ================================================================ Mamba2
class Mamba2(nn.Module):
    """The Mamba2 mixer: in_proj -> causal conv over [x, B, C] -> SSD
    recurrence with a skip (d_skip) -> gated RMSNorm -> out_proj.
    A = -exp(a_log) per head, dt = softplus(dt + dt_bias)."""

    def __init__(self, d_model: int, d_state: int = 64, expand: int = 2,
                 headdim: int = 64, conv_width: int = 4, *, gen=None,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        kw = dict(gen=gen, device=device, dtype=dtype)
        self.d_state, self.headdim = d_state, headdim
        self.d_inner = expand * d_model
        self.n_heads = self.d_inner // headdim
        d_conv = self.d_inner + 2 * d_state
        self.in_proj = Linear(d_model, 2 * self.d_inner + 2 * d_state
                              + self.n_heads, **kw)
        self.conv_w = _normal((conv_width, d_conv), 0.2, gen, device, dtype)

        def const(value):
            return nn.Parameter(torch.full((self.n_heads,), value,
                                           dtype=torch.float32,
                                           device=device),
                                requires_grad=False)
        self.a_log = const(0.0)
        self.dt_bias = const(0.0)
        self.d_skip = const(1.0)
        self.norm = RMSNorm(self.d_inner, device=device, dtype=dtype)
        self.out_proj = Linear(self.d_inner, d_model, **kw)

    def _inputs(self, x, conv_cache=None):
        b, l, _ = x.shape
        di, ds = self.d_inner, self.d_state
        z, xbc, dt = torch.split(self.in_proj(x),
                                 [di, di + 2 * ds, self.n_heads], dim=-1)
        xbc, new_conv = causal_conv(xbc, self.conv_w, conv_cache)
        xbc = F.silu(xbc)
        xin, bmat, cmat = torch.split(xbc, [di, ds, ds], dim=-1)
        dt = _softplus(dt.to(torch.float32) + self.dt_bias)     # (b, l, h)
        a_log = -torch.exp(self.a_log) * dt
        xh = xin.reshape(b, l, self.n_heads, self.headdim)
        return z, xh, bmat, cmat, dt, a_log, new_conv

    def _out(self, y, xh, z, x):
        b, l = x.shape[:2]
        y = y + xh.to(torch.float32) * self.d_skip[:, None]
        y = y.reshape(b, l, -1).to(x.dtype)
        return self.out_proj(rmsnorm(y * F.silu(z), self.norm.g))

    def forward(self, x: torch.Tensor, *, chunk: int = 128,
                init_state: Optional[torch.Tensor] = None):
        """x: (B, L, D) -> (out (B, L, D), the final state)."""
        b, l, _ = x.shape
        z, xh, bmat, cmat, dt, a_log, _ = self._inputs(x)
        shape = (b, l, self.n_heads, self.d_state)
        k = bmat[:, :, None, :].expand(shape)
        q = cmat[:, :, None, :].expand(shape)
        y, final = chunked_gla(a_log, k, xh * dt[..., None], q, chunk=chunk,
                               init_state=init_state)
        return self._out(y, xh, z, x), final

    def step(self, x: torch.Tensor, cache: MambaCache):
        """x: (B, 1, D) -> (out (B, 1, D), a new MambaCache)."""
        _one_token(x, "mamba")
        b = x.shape[0]
        z, xh, bmat, cmat, dt, a_log, new_conv = self._inputs(x, cache.conv)
        shape = (b, self.n_heads, self.d_state)
        k = bmat[:, 0, None, :].expand(shape)
        q = cmat[:, 0, None, :].expand(shape)
        y, new = gla_step(cache.ssm, a_log[:, 0], k,
                          xh[:, 0] * dt[:, 0, :, None], q)
        return self._out(y[:, None], xh, z, x), MambaCache(new, new_conv)


# ================================================================= mLSTM
class MLSTM(nn.Module):
    """The mLSTM mixer: up-projection into (x, z), causal conv + SiLU on x,
    dense q/k/v projections over d_inner (v from the unconvolved x),
    sigmoid input gate, log-sigmoid forget gate, the matrix-memory
    recurrence with its normalizer, RMSNorm gated by SiLU(z), down."""

    def __init__(self, d_model: int, n_heads: int = 4, pf: float = 2.0,
                 conv_width: int = 4, *, gen=None, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        kw = dict(gen=gen, device=device, dtype=dtype)
        self.n_heads = n_heads
        self.d_inner = di = int(d_model * pf)
        self.up = Linear(d_model, 2 * di, **kw)
        self.conv_w = _normal((conv_width, di), 0.2, gen, device, dtype)
        self.q = Linear(di, di, **kw)
        self.k = Linear(di, di, **kw)
        self.v = Linear(di, di, **kw)
        self.igate = Linear(di, n_heads, True, **kw)
        self.fgate = Linear(di, n_heads, True, **kw)
        self.norm = RMSNorm(di, device=device, dtype=dtype)
        self.down = Linear(di, d_model, **kw)

    def _inputs(self, x, conv_cache=None):
        b, l, _ = x.shape
        xi, z = torch.chunk(self.up(x), 2, dim=-1)
        xc, new_conv = causal_conv(xi, self.conv_w, conv_cache)
        xc = F.silu(xc)
        dh = self.d_inner // self.n_heads

        def heads(t):
            return t.reshape(b, l, self.n_heads, dh)
        q = heads(self.q(xc))
        k = heads(self.k(xc)) * dh ** -0.5
        v = heads(self.v(xi))
        ig = torch.sigmoid(self.igate(xc).to(torch.float32))   # (b, l, h)
        fg = F.logsigmoid(self.fgate(xc).to(torch.float32))
        v_aug = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
        return z, q, k * ig[..., None], v_aug, fg, new_conv

    def _out(self, y, z, x):
        b, l = x.shape[:2]
        h = y[..., :-1] / torch.clamp(y[..., -1:].abs(), min=1.0)
        h = h.reshape(b, l, -1).to(x.dtype)
        return self.down(rmsnorm(h, self.norm.g) * F.silu(z))

    def forward(self, x: torch.Tensor, *, chunk: int = 128,
                init_state: Optional[torch.Tensor] = None):
        z, q, k, v, fg, _ = self._inputs(x)
        y, final = chunked_gla(fg, k, v, q, chunk=chunk,
                               init_state=init_state)
        return self._out(y, z, x), final

    def step(self, x: torch.Tensor, cache: MLSTMCache):
        _one_token(x, "mlstm")
        z, q, k, v, fg, new_conv = self._inputs(x, cache.conv)
        y, new = gla_step(cache.state, fg[:, 0], k[:, 0], v[:, 0], q[:, 0])
        return self._out(y[:, None], z, x), MLSTMCache(new, new_conv)


# ================================================================= sLSTM
class SLSTM(nn.Module):
    """The sLSTM block: input projections of the z/i/f/o gates (wx, with
    bias), block-diagonal head-wise recurrent weights r (4, H, dh, dh), the
    log-domain stabilized exponential gating, then RMSNorm and a SwiGLU of
    width 4/3 d_model (gate, up, down)."""

    def __init__(self, d_model: int, n_heads: int = 4, *, gen=None,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        kw = dict(gen=gen, device=device, dtype=dtype)
        self.n_heads, self.d_model = n_heads, d_model
        dh = d_model // n_heads
        d_ff = int(d_model * 4 / 3)
        self.wx = Linear(d_model, 4 * d_model, True, **kw)
        self.r = _normal((4, n_heads, dh, dh), dh ** -0.5, gen, device,
                         dtype)
        self.norm = RMSNorm(d_model, device=device, dtype=dtype)
        self.up = Linear(d_model, d_ff, **kw)
        self.gate = Linear(d_model, d_ff, **kw)
        self.down = Linear(d_ff, d_model, **kw)

    def cell(self, gx: torch.Tensor, st: SLSTMCache) -> SLSTMCache:
        """One timestep. gx: (B, 4D) float32, the input contribution."""
        b = gx.shape[0]
        d = self.d_model
        hprev = st.h.reshape(b, self.n_heads, -1)
        rec = torch.einsum("bhd,ghde->gbhe", hprev,
                           self.r.to(torch.float32)).reshape(4, b, d)
        zt, it, ft, ot = (gx[:, i * d:(i + 1) * d] + rec[i]
                          for i in range(4))
        zt = torch.tanh(zt)
        ot = torch.sigmoid(ot)
        m_new = torch.maximum(ft + st.m, it)
        i_s = torch.exp(it - m_new)
        f_s = torch.exp(ft + st.m - m_new)
        c_new = f_s * st.c + i_s * zt
        n_new = f_s * st.n + i_s
        h_new = ot * c_new / torch.clamp(n_new, min=1e-6)
        return SLSTMCache(c_new, n_new, m_new, h_new)

    def _ffn(self, h, x):
        h = rmsnorm(h.to(x.dtype), self.norm.g)
        return self.down(F.silu(self.gate(h)) * self.up(h))

    def forward(self, x: torch.Tensor, *,
                init: Optional[SLSTMCache] = None):
        """x: (B, L, D) -> (out, the final state): the cell run over L in
        order."""
        b, l, _ = x.shape
        gx = self.wx(x).to(torch.float32)
        st = init if init is not None else init_slstm_cache(
            b, self.d_model, device=x.device)
        hs = []
        for t in range(l):
            st = self.cell(gx[:, t], st)
            hs.append(st.h)
        return self._ffn(torch.stack(hs, dim=1), x), st

    def step(self, x: torch.Tensor, cache: SLSTMCache):
        _one_token(x, "slstm")
        new = self.cell(self.wx(x[:, 0]).to(torch.float32), cache)
        return self._ffn(new.h[:, None], x), new
