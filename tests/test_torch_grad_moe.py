"""Gradients of the MoE family against the JAX package
(`test_torch_grad`'s `check_parity`, same bounds): olmoe and kimi-k2
(a dense layer, then MoE layers with a shared expert). The MoE layer's
index writes into fresh tensors (the expert rows, the combine) and its
aux loss are on the path: at a capacity factor that drops assignments,
and with the aux loss weighted 1, the gradient still matches."""
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.models import init_params
from test_torch_grad import check_parity, make_batch

import _xdist_threads  # noqa: F401  (one torch thread a worker)


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "kimi_k2"])
def test_loss_and_gradient_match_reference(arch):
    tm, jm = check_parity(arch)
    assert abs(tm["aux"].item() - float(jm["aux"])) \
        <= 1e-5 * abs(float(jm["aux"]))


def test_dropped_assignments_and_aux_gradient_match_reference():
    arch, factor = "olmoe_1b_7b", 0.5
    cfg = get_smoke(arch)
    model = init_params(cfg, seed=0, device="cpu")
    block = model.layers[0]
    x = model.embed(torch.from_numpy(make_batch(cfg, 3)["tokens"]).long())
    block.moe.capacity_factor = factor
    with torch.no_grad():
        dropped = int(block.moe.dispatch(
            block.ln2(x).reshape(-1, cfg.d_model)).dropped)
    assert dropped > 0                       # the case drops assignments
    tm, jm = check_parity(arch, aux_weight=1.0, capacity_factor=factor)
    assert tm["aux"].item() > 0
