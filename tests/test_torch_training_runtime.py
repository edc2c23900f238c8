"""The port's training launcher, serve step, bridge and refusals on the
CPU (the Trainer's kill / restart / resume and its watchdog:
tests/test_torch_training_resume.py).

* `launch.train.main(["--smoke", "--device", "cpu",
  "--simulate-preemption", ...])` ends where the uninterrupted launch
  ends: the launcher checkpoints the batches it has consumed, not its
  prefetcher's position;
* `make_serve_step` (greedy decode_step) gives the reference's tokens;
* `bridge.params_to_jax(params_from_jax(p)) == p` bitwise, structure
  and every leaf, for every config; every parameter of the port is a
  leaf of the reference's pytree, and `trainable_` turns on exactly the
  parameters;
* refusals: a resident model cannot be trained; a model whose
  parameters do not require grad cannot take a train step;
  --model-parallel that does not divide the world (alone: any but 1)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import get_smoke as jax_smoke
from repro.launch.steps import make_serve_step as jmake_serve_step
from repro.models import init_caches as jinit_caches
from repro.models import init_params as jinit_params
from repro_torch.bridge import params_from_jax, params_to_jax
from repro_torch.configs import ARCH_IDS, get_smoke
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import train as train_launcher
from repro_torch.launch.steps import make_serve_step, make_train_step
from repro_torch.models import init_caches, init_params, quantize_params
from repro_torch.optim import adamw_init
from repro_torch.runtime import Trainer, TrainerConfig

import _xdist_threads  # noqa: F401  (one torch thread a worker)


def _leaves(model):
    return jax.tree.leaves(params_to_jax(model))


def test_launcher_preemption_ends_where_the_uninterrupted_run_ends(
        tmp_path, capsys):
    common = ["--arch", "olmo_1b", "--smoke", "--steps", "6", "--batch",
              "2", "--seq", "16", "--device", "cpu"]
    full = train_launcher.main(common + ["--ckpt-dir", str(tmp_path / "a")])
    cut = train_launcher.main(common + ["--ckpt-dir", str(tmp_path / "b"),
                                        "--simulate-preemption", "3"])
    out = capsys.readouterr().out
    assert "simulated preemption" in out
    assert "resumed from checkpoint step 3" in out
    assert int(cut.opt_state.step) == int(full.opt_state.step) == 6
    assert cut.pipeline_state.step == full.pipeline_state.step == 6
    for x, y in zip(_leaves(full.model), _leaves(cut.model)):
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-6)
    # the final checkpoint is always written
    assert (tmp_path / "a" / "step_00000006").is_dir()


def test_launcher_refuses_model_parallelism(tmp_path):
    """--model-parallel needs a world it divides: alone, the launcher
    refuses it before starting any process group."""
    with pytest.raises(ValueError, match="does not divide the world of 1"):
        train_launcher.main(["--arch", "olmo_1b", "--smoke", "--device",
                             "cpu", "--model-parallel", "2", "--ckpt-dir",
                             str(tmp_path)])
    assert not torch.distributed.is_initialized()


# ------------------------------------------------------------ serve step
def test_serve_step_matches_reference():
    arch, b, prompt, new = "qwen2_1p5b", 2, 6, 6
    cfg, jcfg = get_smoke(arch), jax_smoke(arch)
    model = init_params(cfg, seed=3, device="cpu")
    jparams = jax.tree.map(jnp.asarray, params_to_jax(model))
    caches = init_caches(cfg, b, 32, device="cpu", dtype=torch.float32)
    jcaches = jinit_caches(jcfg, batch=b, max_len=32, dtype=jnp.float32)
    step, jstep = make_serve_step(cfg), jax.jit(jmake_serve_step(jcfg))
    toks = np.random.RandomState(0).randint(1, cfg.vocab, (b, prompt))
    tok = jtok = None
    with japi.policy(backend="ref"):
        for i in range(prompt + new):
            feed = toks[:, i:i + 1] if i < prompt else None
            t_in = torch.from_numpy(feed) if feed is not None else tok
            j_in = jnp.asarray(feed) if feed is not None else jtok
            tok, caches = step(model, caches, t_in)
            jtok, jcaches = jstep(jparams, jcaches, j_in)
            assert tok.shape == (b, 1)
            np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


# ---------------------------------------------------------------- bridge
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_to_jax_inverts_params_from_jax(arch):
    jcfg, cfg = jax_smoke(arch), get_smoke(arch)
    shapes = jax.eval_shape(lambda k: jinit_params(k, jcfg),
                            jax.random.key(0))
    rng = np.random.RandomState(0)
    p = jax.tree.map(lambda s: rng.randn(*s.shape).astype(s.dtype), shapes)
    model = params_from_jax(p, cfg, device="cpu")
    back = params_to_jax(model)
    flat_p, tree_p = jax.tree_util.tree_flatten(p)
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_p == tree_b
    for x, y in zip(flat_p, flat_b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    # every parameter is a leaf: the elements add up (the shared block
    # once), and trainable_ turns on exactly the parameters
    assert sum(q.numel() for q in model.parameters()) == \
        sum(x.size for x in flat_p)
    model.trainable_()
    assert all(q.requires_grad for q in model.parameters())
    assert not any(t.requires_grad for t in model.buffers())
    model.trainable_(False)
    assert not any(q.requires_grad for q in model.parameters())


# -------------------------------------------------------------- refusals
def test_resident_model_is_refused_for_training(tmp_path):
    cfg = get_smoke("qwen2_1p5b")
    model = quantize_params(init_params(cfg, seed=0, device="cpu"), "int8")
    with pytest.raises(ValueError, match="not trainable"):
        model.trainable_()
    with pytest.raises(ValueError, match="not trainable"):
        Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path)), model,
                device="cpu")
    with pytest.raises(ValueError, match="resident"):
        params_to_jax(model)


def test_train_step_needs_trainable_params():
    cfg = get_smoke("olmo_1b")
    model = init_params(cfg, seed=0, device="cpu")
    opt = adamw_init(list(model.parameters()))
    batch = {k: torch.from_numpy(v) for k, v in next(iter(SyntheticLM(
        DataConfig(vocab=cfg.vocab, batch=2, seq=8)))).items()}
    with pytest.raises(ValueError, match="trainable_"):
        make_train_step(cfg)(model, opt, batch)
