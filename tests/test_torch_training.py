"""The port's training stack against the JAX package's, on the CPU.

* AdamW (`optim.adamw_update`), the global-norm clip and the cosine
  schedule against the reference's on the same gradients and state, f32
  and bf16 params, the clip active and not: params, moments, master and
  norm within 1e-6 relative (not bitwise: the packages' f32 arithmetic
  differs by up to ~2e-7 relative; bf16 params under an active clip came
  out bitwise equal);
* the synthetic data (`data.SyntheticLM`) bitwise equal to the
  reference's: text, audio frames, vision patches, two hosts, and across
  a restored `PipelineState`;
* the Trainer against the reference's Trainer: olmo SMOKE, 8 steps from
  the same weights on the same data: per-step loss within 1e-5 relative,
  final params within 1e-5; step 1 (lr 0 at the pre-increment step)
  leaves every parameter bitwise unchanged in both packages."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.data import DataConfig as JDataConfig
from repro.data import PipelineState as JPipelineState
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch.mesh import make_local_mesh
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import clip_by_global_norm as jclip
from repro.optim import cosine_schedule as jcosine
from repro.runtime import Trainer as JTrainer
from repro.runtime import TrainerConfig as JTrainerConfig
from repro_torch.bridge import params_to_jax
from repro_torch.configs import get_smoke
from repro_torch.data import DataConfig, PipelineState, SyntheticLM
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_params
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               cosine_schedule, global_norm)
from repro_torch.runtime import Trainer, TrainerConfig

import _xdist_threads  # noqa: F401  (one torch thread a worker)

RTOL = 1e-6
SHAPES = [(4, 8), (16,), (3, 5, 2)]


def close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= rtol * max(float(np.abs(want).max()), 1e-30), err


# ------------------------------------------------------------- optimizer
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gscale", [0.01, 10.0])     # clip idle / active
def test_adamw_matches_reference(dtype, gscale):
    rng = np.random.RandomState(0)
    p_np = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    jp = {f"p{i}": jnp.asarray(a, dtype) for i, a in enumerate(p_np)}
    tp = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in p_np]
    js, ts = jadamw_init(jp), adamw_init(tp)
    assert all(m.dtype == torch.float32 for m in ts.master)
    for _ in range(4):
        g_np = [(rng.randn(*s) * gscale).astype(np.float32) for s in SHAPES]
        jg = {f"p{i}": jnp.asarray(a, dtype) for i, a in enumerate(g_np)}
        tg = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in g_np]
        jlr = jcosine(js.step, base_lr=1e-2, warmup=2, total=10)
        tlr = cosine_schedule(ts.step, base_lr=1e-2, warmup=2, total=10)
        jp, js, jnorm = jadamw_update(jg, js, jp, lr=jlr)
        out, ts, tnorm = adamw_update(tg, ts, tp, lr=tlr)
        assert out is not tp and all(a is b for a, b in zip(out, tp))
        close(tlr, jlr)
        close(tnorm, jnorm)
        assert int(ts.step) == int(js.step)
        for i in range(len(SHAPES)):
            key = f"p{i}"
            assert tp[i].dtype == getattr(torch, dtype)
            close(ts.mu[i], js.mu[key])
            close(ts.nu[i], js.nu[key])
            close(ts.master[i], js.master[key])
            close(tp[i].float(), jp[key].astype(jnp.float32))


def test_first_update_at_step_zero_changes_nothing():
    """cosine_schedule(0) is 0, so the reference's first train step (lr
    taken before the increment) leaves every param as it was: the port's
    too, bitwise, while the moments and the step move."""
    rng = np.random.RandomState(1)
    tp = [torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in SHAPES]
    before = [p.clone() for p in tp]
    state = adamw_init(tp)
    lr = cosine_schedule(state.step, base_lr=3e-4, warmup=2, total=10)
    assert float(lr) == 0.0
    grads = [torch.from_numpy(rng.randn(*s).astype(np.float32))
             for s in SHAPES]
    adamw_update(grads, state, tp, lr=lr)
    assert int(state.step) == 1
    assert all(torch.equal(a, b) for a, b in zip(tp, before))
    assert all(m.abs().sum() > 0 for m in state.mu)


def test_clip_and_schedule_match_reference():
    rng = np.random.RandomState(2)
    g_np = [(rng.randn(*s) * 30).astype(np.float32) for s in SHAPES]
    jg, jn = jclip({f"p{i}": jnp.asarray(a) for i, a in enumerate(g_np)},
                   1.0)
    tg, tn = clip_by_global_norm([torch.from_numpy(a) for a in g_np], 1.0)
    close(tn, jn)
    close(global_norm(tg), 1.0)
    for i, t in enumerate(tg):
        close(t, jg[f"p{i}"])
    for step in range(0, 130, 3):
        want = jcosine(jnp.asarray(step), base_lr=3e-4, warmup=10, total=100)
        close(cosine_schedule(torch.tensor(step, dtype=torch.int32),
                              base_lr=3e-4, warmup=10, total=100), want)
    assert float(cosine_schedule(0, base_lr=1.0, warmup=10, total=100)) == 0
    assert float(cosine_schedule(100, base_lr=1.0, warmup=10, total=100)) \
        == pytest.approx(0.1, abs=1e-3)


# ------------------------------------------------------------------ data
DATA_CASES = {
    "text": dict(vocab=512, batch=4, seq=32, seed=11),
    "audio": dict(vocab=512, batch=2, seq=16, seed=3, frontend="audio",
                  frontend_len=16, d_model=64),
    "vision": dict(vocab=97, batch=2, seq=16, seed=4, frontend="vision",
                   frontend_len=8, d_model=64),
    "two_hosts": dict(vocab=512, batch=4, seq=16, seed=5, host_id=1,
                      n_hosts=2),
}


def assert_same_batch(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("case", sorted(DATA_CASES))
def test_synthetic_batches_bitwise_equal_reference(case):
    kw = DATA_CASES[case]
    mine, ref = SyntheticLM(DataConfig(**kw)), JSyntheticLM(JDataConfig(**kw))
    for _ in range(3):
        assert_same_batch(next(mine), next(ref))
    saved = mine.state.to_dict()
    assert saved == ref.state.to_dict() == {"step": 3}
    # a restored stream continues where the saved one stopped
    mine2 = SyntheticLM(DataConfig(**kw), PipelineState.from_dict(saved))
    ref2 = JSyntheticLM(JDataConfig(**kw), JPipelineState.from_dict(saved))
    want = next(ref)
    assert_same_batch(next(mine2), want)
    assert_same_batch(next(ref2), want)


# --------------------------------------------------------------- trainer
def test_trainer_matches_reference_trainer(tmp_path):
    arch, steps = "olmo_1b", 8
    tcfg_port, jcfg = get_smoke(arch), jax_smoke(arch)
    model = init_params(tcfg_port, seed=7, device="cpu")
    np_params = params_to_jax(model)
    data = dict(vocab=tcfg_port.vocab, batch=4, seq=32, seed=11)

    def trainer_cfg(cls, d):
        return cls(ckpt_dir=str(d), ckpt_every=10**9, total_steps=steps,
                   base_lr=1e-3, warmup=2)

    ref = JTrainer(jcfg, trainer_cfg(JTrainerConfig, tmp_path / "ref"),
                   make_local_mesh(),
                   params=jax.tree.map(jnp.asarray, np_params))
    mine = Trainer(tcfg_port, trainer_cfg(TrainerConfig, tmp_path / "port"),
                   model, device="cpu")
    ref_data, my_data = (iter(JSyntheticLM(JDataConfig(**data))),
                         iter(SyntheticLM(DataConfig(**data))))

    # step 1: lr 0, no param moves, in either package
    ref.run(ref_data, 1)
    mine.run(my_data, 1)
    assert mine.metrics_log[0]["lr"] == ref.metrics_log[0]["lr"] == 0.0
    for got, want in zip(jax.tree.leaves(params_to_jax(mine.model)),
                         jax.tree.leaves(np_params)):
        np.testing.assert_array_equal(got, want)
    for want, got in zip(jax.tree.leaves(ref.params),
                         jax.tree.leaves(np_params)):
        np.testing.assert_array_equal(np.asarray(want), got)

    ref.run(ref_data, steps - 1)
    mine.run(my_data, steps - 1)
    assert int(mine.opt_state.step) == int(ref.opt_state.step) == steps
    for got, want in zip(mine.metrics_log, ref.metrics_log):
        for key in ("loss", "aux", "grad_norm", "lr"):
            assert abs(got[key] - want[key]) <= 1e-5 * abs(want[key]), \
                (key, got[key], want[key])
    assert mine.metrics_log[-1]["loss"] < mine.metrics_log[0]["loss"]
    for got, want in zip(jax.tree.leaves(params_to_jax(mine.model)),
                         jax.tree.leaves(ref.params)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


def test_trainer_batches_of_the_frontend_families_train(tmp_path):
    """A train step on whisper's frames and internvl2's patch embeddings
    (the batch keys the trainer moves to its device)."""
    for arch in ("whisper_tiny", "internvl2_76b"):
        cfg = get_smoke(arch)
        tr = Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path / arch),
                                        ckpt_every=10**9, warmup=1),
                     seed=0, device="cpu")
        src = SyntheticLM(DataConfig(
            vocab=cfg.vocab, batch=2, seq=16, frontend=cfg.frontend,
            frontend_len=cfg.frontend_len, d_model=cfg.d_model))
        tr.run(iter(src), 2)
        assert all(np.isfinite(m["loss"]) and m["grad_norm"] > 0
                   for m in tr.metrics_log)
        grads = [p.grad for p in tr.model.parameters()]
        assert all(g is not None for g in grads)
        if cfg.family == "audio":              # the encoder gets gradient
            assert tr.model.encoder[0].attn.q.w.grad.abs().sum() > 0


def test_train_step_refuses_a_model_of_another_config(tmp_path):
    """A step made for one config refuses a model of another."""
    cfg = get_smoke("olmo_1b")
    tr = Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path)), seed=0,
                 device="cpu")
    other = dataclasses.replace(cfg, name="olmo_other")
    step = make_train_step(other)
    batch = {k: torch.from_numpy(v) for k, v in next(iter(SyntheticLM(
        DataConfig(vocab=cfg.vocab, batch=2, seq=8)))).items()}
    with pytest.raises(ValueError, match="was made for"):
        step(tr.model, tr.opt_state, batch)
