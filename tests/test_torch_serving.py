"""Port parity of the serving engine: greedy tokens identical to the JAX
`ServingEngine` (its default reference route) for a mixed batch with
chunked admission, on qwen2 dense, qwen2 int8-KV and llama2; inside the
port, chunked and one-shot admission give the same tokens; plus the
engine's request validation, routes, warmup and occupancy surface."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.models import init_params as jinit_params
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch import api
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.kernels.flash_attention import KERNELS
from repro_torch.models import init_params
from repro_torch.serving import Request, ServingEngine

import _xdist_threads  # noqa: F401  (one torch thread a worker)

PROMPT_LENS = [3, 20, 5, 18]
MAX_NEW = [6, 4, 8, 5]
MAX_LEN = 64
CASES = [("qwen2_1p5b", False), ("qwen2_1p5b", True), ("llama2_7b", False)]


def _prompts(vocab, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, n).astype(np.int32) for n in PROMPT_LENS]


def _serve(engine, request_cls, prompts):
    for rid, (p, m) in enumerate(zip(prompts, MAX_NEW)):
        assert engine.submit(request_cls(rid, p, max_new_tokens=m))
    return {r.rid: list(r.out_tokens) for r in engine.run_until_drained()}


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def served(request):
    """One JAX engine run per config (module-scoped: built once), and the
    port's model holding the same weights."""
    arch, kv_quant = request.param
    jcfg = dataclasses.replace(jax_smoke(arch), kv_quant=kv_quant)
    tcfg = dataclasses.replace(get_smoke(arch), kv_quant=kv_quant)
    jparams = jinit_params(jax.random.key(0), jcfg)
    prompts = _prompts(jcfg.vocab)
    want = _serve(JServingEngine(jcfg, jparams, slots=2, max_len=MAX_LEN,
                                 prefill_chunk=8), JRequest, prompts)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                            device="cpu")
    return tcfg, model, prompts, want


def test_greedy_tokens_match_jax_engine(served):
    cfg, model, prompts, want = served
    eng = ServingEngine(cfg, model, slots=2, max_len=MAX_LEN, prefill_chunk=8)
    got = _serve(eng, Request, prompts)
    assert got == want
    assert eng.stats.generated_tokens == sum(MAX_NEW)
    assert eng.stats.prefill_tokens == sum(PROMPT_LENS)


@pytest.mark.parametrize("chunk", [1, 5, 32])
def test_chunked_equals_one_shot_admission(served, chunk):
    """Chunk widths 1 (every prompt token its own launch), 5 and 32 (one
    shot: wider than every prompt) give the same tokens."""
    cfg, model, prompts, want = served
    eng = ServingEngine(cfg, model, slots=2, max_len=MAX_LEN,
                        prefill_chunk=chunk)
    assert _serve(eng, Request, prompts) == want


def test_routes_and_cpu_kernel_wrappers():
    """The default policy routes to the kernels; on CPU tensors their
    wrappers run the plain versions and count no kernel launch."""
    cfg = get_smoke("qwen2_1p5b")
    model = init_params(cfg, seed=1, device="cpu")
    eng = ServingEngine(cfg, model, slots=2, max_len=32, prefill_chunk=4)
    assert (eng.decode_route(), eng.prefill_route()) == \
        ("cuda-decode", "cuda-prefill")
    ref = ServingEngine(cfg, model, slots=2, max_len=32, prefill_chunk=4,
                        policy=api.ExecutionPolicy(backend="ref"))
    assert (ref.decode_route(), ref.prefill_route()) == ("ref", "ref")
    before = [k.launches for k in KERNELS]
    prompts = [np.arange(1, 8, dtype=np.int32), np.arange(3, 6,
                                                          dtype=np.int32)]
    for e in (eng, ref):
        for rid, p in enumerate(prompts):
            e.submit(Request(rid, p, max_new_tokens=3))
    got = {r.rid: r.out_tokens for r in eng.run_until_drained()}
    assert got == {r.rid: r.out_tokens for r in ref.run_until_drained()}
    assert [k.launches for k in KERNELS] == before


def test_warmup_is_a_noop_on_the_caches():
    cfg = dataclasses.replace(get_smoke("qwen2_1p5b"), kv_quant=True)
    model = init_params(cfg, seed=2, device="cpu")
    eng = ServingEngine(cfg, model, slots=2, max_len=16, prefill_chunk=4)
    eng.submit(Request(0, np.arange(1, 6, dtype=np.int32), max_new_tokens=2))
    eng.step()
    snap = [{f.name: getattr(c, f.name).clone()
             for f in dataclasses.fields(c)} for c in eng.caches]
    eng.warmup()
    for c, s in zip(eng.caches, snap):
        for name, t in s.items():
            assert torch.equal(getattr(c, name), t), name


def test_submit_validation_and_limits():
    cfg = get_smoke("llama2_7b")
    eng = ServingEngine(cfg, init_params(cfg, seed=0, device="cpu"), slots=1,
                        max_len=32, max_queue=2)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(Request(0, np.arange(1, 28, dtype=np.int32),
                           max_new_tokens=6))           # 27 + 6 > 32
    with pytest.raises(ValueError, match="empty"):
        eng.submit(Request(1, np.zeros(0, np.int32)))
    with pytest.raises(ValueError, match="1-D"):
        eng.submit(Request(2, np.ones((2, 2), np.int32)))
    with pytest.raises(TypeError, match="integer"):
        eng.submit(Request(3, np.ones(3, np.float32)))
    with pytest.raises(TypeError, match="max_new_tokens"):
        eng.submit(Request(4, np.ones(3, np.int32), max_new_tokens=2.0))
    assert eng.submit(Request(5, np.arange(1, 27, dtype=np.int32),
                              max_new_tokens=6))        # 26 + 6 == 32
    assert eng.submit(Request(6, np.asarray([1, 2], np.int32),
                              max_new_tokens=0))
    rejected = Request(7, np.asarray([3], np.int32))
    assert not eng.submit(rejected)                     # queue full
    assert rejected.status == "REJECTED" and eng.stats.rejected_submits == 1
    assert eng.occupancy() == [None] and eng.utilization() == 0.0
    eng.step()      # one chunk admits the prompt (first token), one decode
    occ = eng.occupancy()[0]
    assert occ == {"rid": 5, "generated": 2, "remaining": 4}
    assert eng.utilization() == 1.0
    done = {r.rid: r for r in eng.run_until_drained()}
    assert len(done[5].out_tokens) == 6 and done[6].out_tokens == []
    assert eng.utilization() == 0.0


def test_engine_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(get_smoke("qwen2_1p5b"))
