"""Gradients of the frontend families against the JAX package
(`test_torch_grad`'s `check_parity`, same bounds): whisper (the encoder
reaches the loss through the cross attention, so its gradient shows that
`encode` records) and internvl2 (patch embeddings prepended)."""
import pytest

from test_torch_grad import check_parity

import _xdist_threads  # noqa: F401  (one torch thread a worker)


@pytest.mark.parametrize("arch", ["whisper_tiny", "internvl2_76b"])
def test_loss_and_gradient_match_reference(arch):
    check_parity(arch)
