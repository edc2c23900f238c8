"""The serving engine's fault surface on the encoder-decoder family
(whisper SMOKE, on the CPU), where the audio belongs to a SLOT, not to a
request: a request hears the frames of the slot it lands in.

* `ServingEngine(paged=True)` raises ValueError for a model with cross
  attention (ROADMAP C), beside the reason: on three requests, the third
  sharing the first's 20-token head but landing in the other slot, the
  reference's paged engine shares the prefix blocks slot 0 wrote, whose
  K/V past the first decoder layer depend on slot 0's audio, and gives
  that request other tokens than its flat engine, which the port's flat
  engine equals;
* a quarantine replay that lands in the other slot hears the other audio:
  its tokens change in the reference (its invariant "a replayed row gives
  the same output" does not hold for audio; ROADMAP C), and the port's
  tokens, statuses, replays and counters equal the reference's;
* a snapshot restored into an engine built with other frames finishes on
  those frames, in both packages alike; the restore does not re-encode
  them (the memory is the new engine's own)."""
import jax
import numpy as np
import pytest

from repro.configs import get_smoke as jax_smoke
from repro.models import init_params as jinit_params
from repro.serving import FaultPlan as JFaultPlan
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.models import init_params
from repro_torch.serving import FaultPlan, Request, ServingEngine

import _xdist_threads  # noqa: F401  (one torch thread a worker)

ARCH = "whisper_tiny"
GEO = dict(slots=2, max_len=64)
NAN = float("nan")
# the quarantine: a NaN logits poison of slot 1 at step 11, after slot 0's
# request finished, so the replay is admitted into slot 0
POISON = dict(step=11, slot=1, target="logits", value=NAN)


@pytest.fixture(scope="module")
def setup():
    """The weights in both packages, the frames (slot 1's three times as
    loud as slot 0's), a second set of frames, and the three requests:
    head + 3 tokens (12 new), an unrelated 5-token prompt (1 new), head +
    5 tokens (12 new); the head is 20 tokens."""
    jcfg, cfg = jax_smoke(ARCH), get_smoke(ARCH)
    jparams = jax.jit(jinit_params, static_argnums=1)(jax.random.key(0),
                                                      jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    rng = np.random.RandomState(5)
    head = rng.randint(1, cfg.vocab, 20)
    spec = [(np.concatenate([head, rng.randint(1, cfg.vocab, 3)]), 12),
            (rng.randint(1, cfg.vocab, 5), 1),
            (np.concatenate([head, rng.randint(1, cfg.vocab, 5)]), 12)]
    spec = [(p.astype(np.int32), m) for p, m in spec]
    shape = (GEO["slots"], cfg.frontend_len, cfg.d_model)
    frames = rng.randn(*shape).astype(np.float32)
    frames[1] *= 3
    other = rng.randn(*shape).astype(np.float32)
    return jcfg, cfg, jparams, model, spec, frames, other


def _submit(eng, request_cls, spec):
    for rid, (p, m) in enumerate(spec):
        assert eng.submit(request_cls(rid, p, max_new_tokens=m))


def _outcome(finished):
    return {r.rid: (r.status, list(r.out_tokens), r.replays)
            for r in finished}


@pytest.fixture(scope="module")
def reference(setup, tmp_path_factory):
    """The JAX engines' outcomes: flat (snapshotted after 3 steps, then
    drained), paged (block size 8), flat under the poison, and a second
    flat engine built with the other frames that restores the snapshot."""
    jcfg, _, jparams, _, spec, frames, other = setup
    snap = tmp_path_factory.mktemp("jax_snapshot")
    out = {}
    eng = JServingEngine(jcfg, jparams, frames=frames, **GEO)
    _submit(eng, JRequest, spec)
    for _ in range(3):
        eng.step()
    out["before_snapshot"] = {r.rid for r in eng.finished}
    eng.snapshot(snap)
    out["flat"] = _outcome(eng.run_until_drained())
    eng = JServingEngine(jcfg, jparams, frames=frames, paged=True,
                         block_size=8, **GEO)
    _submit(eng, JRequest, spec)
    out["paged"] = _outcome(eng.run_until_drained())
    out["pool"] = eng.pool_stats()
    eng = JServingEngine(jcfg, jparams, frames=frames, **GEO)
    eng.arm_fault_plan(JFaultPlan.single("poison", **POISON))
    _submit(eng, JRequest, spec)
    out["poisoned"] = _outcome(eng.run_until_drained())
    out["poisoned_quarantines"] = eng.stats.quarantines
    eng = JServingEngine(jcfg, jparams, frames=other, **GEO)
    assert eng.restore(snap) == 3
    out["restored"] = _outcome(eng.run_until_drained())
    return out


def test_paged_engine_refused_for_cross_attention(setup):
    _, cfg, _, model, _, frames, _ = setup
    with pytest.raises(ValueError, match="ROADMAP C"):
        ServingEngine(cfg, model, frames=frames, paged=True, block_size=8,
                      **GEO)
    # internvl2 has no cross attention: its paged engine builds
    vcfg = get_smoke("internvl2_76b")
    eng = ServingEngine(vcfg, init_params(vcfg, device="cpu"), paged=True,
                        block_size=8, **GEO)
    assert eng.pool_stats()["paged"]


def test_reference_paged_engine_changes_a_cross_slot_prefix_hit(setup,
                                                               reference):
    """Why the port refuses: the third request lands in slot 1 and takes
    the 20 head tokens slot 0 wrote (one prefix hit); in the reference's
    paged engine its tokens then differ from its flat engine's, while the
    first two requests' agree. The port's flat engine equals the
    reference's flat engine."""
    _, cfg, _, model, spec, frames, _ = setup
    pool = reference["pool"]
    assert pool["prefix_hits"] == 1 and pool["shared_tokens"] == 20
    flat, paged = reference["flat"], reference["paged"]
    assert flat[0] == paged[0] and flat[1] == paged[1]
    assert flat[2] != paged[2]
    eng = ServingEngine(cfg, model, frames=frames, **GEO)
    _submit(eng, Request, spec)
    assert _outcome(eng.run_until_drained()) == flat


def test_replay_into_the_other_slot_hears_its_audio(setup, reference):
    """Slot 1 poisoned at step 11: the third request is quarantined and
    replayed into slot 0 (free by then), whose audio it then hears: its
    tokens change from the unfaulted run in the reference, and the port
    gives the reference's tokens, statuses, replays and one quarantine."""
    _, cfg, _, model, spec, frames, _ = setup
    want = reference["poisoned"]
    assert reference["poisoned_quarantines"] == 1
    assert want[2][2] == 1 and want[2][1] != reference["flat"][2][1]
    assert {r: want[r] for r in (0, 1)} == {r: reference["flat"][r]
                                            for r in (0, 1)}
    eng = ServingEngine(cfg, model, frames=frames, **GEO)
    eng.arm_fault_plan(FaultPlan.single("poison", **POISON))
    _submit(eng, Request, spec)
    assert _outcome(eng.run_until_drained()) == want
    assert eng.stats.quarantines == 1


def test_snapshot_restored_under_other_frames(setup, reference, tmp_path):
    """A snapshot after 3 steps, restored into an engine built with other
    frames: the rows mid-stream finish on the new engine's audio, so the
    tokens differ from the original engine's continuation, in the
    reference and in the port alike; the port's equal the reference's."""
    _, cfg, _, model, spec, frames, other = setup
    eng = ServingEngine(cfg, model, frames=frames, **GEO)
    _submit(eng, Request, spec)
    for _ in range(3):
        eng.step()
    assert {r.rid for r in eng.finished} == reference["before_snapshot"]
    eng.snapshot(tmp_path)
    assert _outcome(eng.run_until_drained()) == reference["flat"]
    back = ServingEngine(cfg, model, frames=other, **GEO)
    memory = back.memory
    assert back.restore(tmp_path) == 3
    assert back.memory is memory
    got = _outcome(back.run_until_drained())
    assert got == reference["restored"]
    assert got != {r: reference["flat"][r] for r in got}
