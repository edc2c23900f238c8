"""Gradients of the recurrent families against the JAX package
(`test_torch_grad`'s `check_parity`, same bounds): zamba2 (Mamba2 layers
and ONE shared attention block at two positions, whose gradient is the
sum over them, as the reference's closed-over params give it) and xlstm
(mLSTM and sLSTM, their chunk and step scans Python loops in the
port)."""
import pytest

from test_torch_grad import check_parity

import _xdist_threads  # noqa: F401  (one torch thread a worker)


@pytest.mark.parametrize("arch", ["zamba2_2p7b", "xlstm_1p3b"])
def test_loss_and_gradient_match_reference(arch):
    check_parity(arch)
