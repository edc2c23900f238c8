"""Gradients of the port against the JAX package (`test_torch_grad`'s
`check_parity`, same bounds): internlm2 and gemma2 (softcaps, sandwich
norms, local/global layers), qwen2 under QuantPolicy(fp8a, fp8a) (the
STE and the pow2 scales of detached operands), and a 128-aligned length,
where under autograd every attention call takes the `ref` route and under
`torch.no_grad()` the full-sequence kernel's route (its plain version on
the CPU), both at the reference's loss."""
import pytest

from test_torch_grad import check_parity

import _xdist_threads  # noqa: F401  (one torch thread a worker)


@pytest.mark.parametrize("arch", ["internlm2_20b", "gemma2_27b"])
def test_loss_and_gradient_match_reference(arch):
    check_parity(arch)


def test_fp8_policy_gradient_matches_reference():
    """QuantPolicy(fp8a, fp8a) on every Linear: the fake-quant STE and the
    pow2 scales taken from detached operands (the reference's
    stop_gradient) give the reference's gradient."""
    check_parity("qwen2_1p5b", policy=("fp8a", "fp8a"))
