"""The port's Trainer on the CPU: its own fault tolerance.

* kill / restart / resume (tests/test_system.py's contract): a run that
  checkpoints at step 4, dies and restarts ends with the params of an
  uninterrupted one (atol 1e-6), the data position restored;
* a restore puts back the checkpointed params and optimizer state
  bitwise, the step a 0-d tensor;
* the straggler watchdog raises StragglerAbort (tests/test_substrate.py)."""
import jax
import numpy as np
import pytest
import torch

from repro_torch.bridge import params_to_jax
from repro_torch.configs import get_smoke
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.runtime import StragglerAbort, Trainer, TrainerConfig

import _xdist_threads  # noqa: F401  (one torch thread a worker)


def _leaves(model):
    return jax.tree.leaves(params_to_jax(model))


def test_train_kill_restart_resume(tmp_path):
    cfg = get_smoke("olmo_1b")

    def data(state=None):
        return SyntheticLM(DataConfig(vocab=cfg.vocab, batch=4, seq=32,
                                      seed=11), state)

    def tcfg(d):
        return TrainerConfig(ckpt_dir=str(d), ckpt_every=4, total_steps=8,
                             base_lr=1e-3, warmup=2)

    full = Trainer(cfg, tcfg(tmp_path / "full"), seed=7, device="cpu")
    full.run(iter(data()), 8)

    a = Trainer(cfg, tcfg(tmp_path / "int"), seed=7, device="cpu")
    src = data()
    a.attach_pipeline(src.state)
    a.run(iter(src), 4)
    a.ckpt.wait()
    del a                                          # crash

    b = Trainer(cfg, tcfg(tmp_path / "int"), seed=99, device="cpu")
    assert b.maybe_restore() == 4
    assert b.pipeline_state.step == 4 and int(b.opt_state.step) == 4
    src2 = data(b.pipeline_state)
    b.attach_pipeline(src2.state)
    b.run(iter(src2), 4)
    for x, y in zip(_leaves(full.model), _leaves(b.model)):
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-6)


def test_restore_puts_back_the_checkpointed_state(tmp_path):
    cfg = get_smoke("olmo_1b")
    tc = TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=2, warmup=1)
    tr = Trainer(cfg, tc, seed=0, device="cpu")
    tr.run(iter(SyntheticLM(DataConfig(vocab=cfg.vocab, batch=2, seq=16))),
           2)
    tr2 = Trainer(cfg, tc, seed=1, device="cpu")
    assert tr2.maybe_restore() == 2
    for x, y in zip(_leaves(tr.model), _leaves(tr2.model)):
        np.testing.assert_array_equal(x, y)
    for field in ("mu", "nu", "master"):
        for x, y in zip(getattr(tr.opt_state, field),
                        getattr(tr2.opt_state, field)):
            assert torch.equal(x, y)
    assert tr2.opt_state.step.shape == () and int(tr2.opt_state.step) == 2


def test_straggler_watchdog():
    tr = Trainer.__new__(Trainer)
    tr.tcfg = TrainerConfig(ckpt_dir="unused", straggler_factor=2.0,
                            max_straggler_strikes=3, min_timing_samples=4)
    tr.step_times = [0.1] * 10
    tr.straggler_strikes = 0
    tr._watchdog(0.1)
    assert tr.straggler_strikes == 0
    with pytest.raises(StragglerAbort):
        for _ in range(5):
            tr._watchdog(1.0)     # 10x median
