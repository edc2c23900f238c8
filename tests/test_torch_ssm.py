"""Port parity of the recurrent blocks (`repro_torch.models.ssm`) against
the JAX package's `repro.models.ssm`, module by module, from the same
numpy inputs and the same weights (JAX's init copied with
`bridge.mixer_from_jax`), within 1e-5 (float32):

* `chunked_gla` with and without an initial state, at an L that is not a
  multiple of the chunk, and `gla_step`;
* the causal conv with and without a cache;
* Mamba2, mLSTM and sLSTM over a whole sequence (output and final state)
  and one cached step (output and every cache field)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.bridge import mixer_from_jax
from repro_torch.models import ssm

import _xdist_threads  # noqa: F401  (one torch thread a worker)

TOL = 1e-5


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _np(*shape, seed, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _gla_inputs(b, l, h, p, s, seed):
    a_log = -np.abs(_np(b, l, h, seed=seed, scale=0.3))
    return (a_log, _np(b, l, h, p, seed=seed + 1),
            _np(b, l, h, s, seed=seed + 2), _np(b, l, h, p, seed=seed + 3))


@pytest.mark.parametrize("with_init", [False, True])
def test_chunked_gla_matches(with_init):
    """L = 45 over chunks of 16: two full chunks and a padded one."""
    b, l, h, p, s = 2, 45, 3, 8, 5
    ins = _gla_inputs(b, l, h, p, s, seed=0)
    init = _np(b, h, p, s, seed=9) if with_init else None
    jy, jst = jssm.chunked_gla(*map(jnp.asarray, ins), chunk=16,
                               init_state=None if init is None
                               else jnp.asarray(init))
    y, st = ssm.chunked_gla(*map(_t, ins), chunk=16,
                            init_state=None if init is None else _t(init))
    assert y.dtype == st.dtype == torch.float32
    _close(y, jy)
    _close(st, jst)


def test_chunked_gla_equals_the_step_recurrence():
    """The chunked evaluation and `gla_step` run token by token compute
    the same function (the port against itself, and against JAX)."""
    b, l, h, p, s = 1, 21, 2, 4, 3
    a_log, k, v, q = map(_t, _gla_inputs(b, l, h, p, s, seed=4))
    y, final = ssm.chunked_gla(a_log, k, v, q, chunk=8)
    state = torch.zeros(b, h, p, s)
    for t in range(l):
        yt, state = ssm.gla_step(state, a_log[:, t], k[:, t], v[:, t],
                                 q[:, t])
        _close(yt, y[:, t])
    _close(state, final)


def test_gla_step_matches():
    b, h, p, s = 3, 4, 6, 7
    state = _np(b, h, p, s, seed=1)
    a_log = -np.abs(_np(b, h, seed=2))
    k, v, q = _np(b, h, p, seed=3), _np(b, h, s, seed=4), _np(b, h, p, seed=5)
    jy, jnew = jssm.gla_step(*map(jnp.asarray, (state, a_log, k, v, q)))
    y, new = ssm.gla_step(*map(_t, (state, a_log, k, v, q)))
    _close(y, jy)
    _close(new, jnew)


@pytest.mark.parametrize("cached", [False, True])
def test_causal_conv_matches(cached):
    x, w = _np(2, 7, 5, seed=1), _np(4, 5, seed=2)
    cache = _np(2, 3, 5, seed=3) if cached else None
    jy, jc = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                               None if cache is None else jnp.asarray(cache))
    y, c = ssm.causal_conv(_t(x), _t(w), None if cache is None else _t(cache))
    _close(y, jy)
    _close(c, jc)


# ------------------------------------------------------------- the mixers
D = 32


def _mamba():
    jp = jssm.mamba_init(jax.random.key(0), D, d_state=8, expand=2,
                         headdim=16)
    mod = ssm.Mamba2(D, 8, 2, 16, device="cpu")
    return jp, mod, dict(d_state=8, headdim=16)


def _mlstm():
    jp = jssm.mlstm_init(jax.random.key(1), D, n_heads=4)
    return jp, ssm.MLSTM(D, 4, device="cpu"), dict(n_heads=4)


def _slstm():
    jp = jssm.slstm_init(jax.random.key(2), D, n_heads=4)
    return jp, ssm.SLSTM(D, 4, device="cpu"), dict(n_heads=4)


MIXERS = {"mamba": (_mamba, jssm.mamba_apply, jssm.mamba_step,
                    lambda b: jssm.mamba_cache_init(
                        b, D, d_state=8, expand=2, headdim=16)),
          "mlstm": (_mlstm, jssm.mlstm_apply, jssm.mlstm_step,
                    lambda b: jssm.mlstm_cache_init(b, D, n_heads=4)),
          "slstm": (_slstm, jssm.slstm_apply, jssm.slstm_step,
                    lambda b: jssm.slstm_cache_init(b, D))}
CACHES = {"mamba": ssm.MambaCache, "mlstm": ssm.MLSTMCache,
          "slstm": ssm.SLSTMCache}


def _mixer(kind):
    make = MIXERS[kind][0]
    jp, mod, kw = make()
    # non-trivial gains and per-head constants, so a wrong mapping shows
    rng = np.random.RandomState(3)
    jp["norm"] = {"g": jnp.asarray(1 + 0.3 * rng.randn(
        *jp["norm"]["g"].shape).astype(np.float32))}
    for name in ("a_log", "dt_bias", "d_skip"):
        if name in jp:
            jp[name] = jnp.asarray(0.5 * rng.randn(*jp[name].shape)
                                   .astype(np.float32))
    mixer_from_jax(mod, jax.tree.map(np.asarray, jp), device="cpu")
    return jp, mod, kw


@pytest.mark.parametrize("kind", sorted(MIXERS))
def test_mixer_apply_matches(kind):
    """A whole sequence of L = 150 (mamba/mLSTM: two chunks of 128, the
    second padded): the output and the final state."""
    jp, mod, kw = _mixer(kind)
    x = _np(2, 150, D, seed=5)
    jout, jfinal = MIXERS[kind][1](jp, jnp.asarray(x), **kw)
    out, final = mod(_t(x))
    _close(out, jout)
    if kind == "slstm":
        for name in ("c", "n", "m", "h"):
            _close(getattr(final, name), getattr(jfinal, name))
    else:
        _close(final, jfinal)


@pytest.mark.parametrize("kind", sorted(MIXERS))
def test_mixer_step_matches(kind):
    """Three cached steps from a non-zero cache (the sLSTM's stabilizer
    from its init), every field compared after each."""
    jp, mod, kw = _mixer(kind)
    b = 3
    jc = MIXERS[kind][3](b)
    if kind != "slstm":
        jc = jc._replace(**{f: jnp.asarray(_np(*a.shape, seed=i, scale=0.5))
                            for i, (f, a) in enumerate(jc._asdict().items())})
    cache = CACHES[kind](**{f: _t(a) for f, a in jc._asdict().items()})
    for t in range(3):
        x = _np(b, 1, D, seed=20 + t)
        jout, jc = MIXERS[kind][2](jp, jnp.asarray(x), jc, **kw)
        out, cache = mod.step(_t(x), cache)
        _close(out, jout)
        for f, a in jc._asdict().items():
            _close(getattr(cache, f), np.asarray(a, np.float32))
            assert getattr(cache, f).dtype == torch.float32


def test_step_refuses_a_wider_launch():
    """The reference's steps read token 0 of each row only; the port's
    raise on a wider input instead of computing garbage."""
    _, mod, _ = _mixer("mamba")
    cache = ssm.init_mamba_cache(1, D, d_state=8, expand=2, headdim=16,
                                 device="cpu")
    with pytest.raises(ValueError, match="one token"):
        mod.step(torch.zeros(1, 2, D), cache)
