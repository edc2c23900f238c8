"""The AIO quantizer (per-row pow2 scale + codes): its CUDA kernel wrapper,
plain version, reference, and the `quantize` registry impls."""
from . import ops  # noqa: F401  (registers the quantize impls)
from .ops import KERNEL_FLOOR, aio_quant, aio_quant_plain  # noqa: F401
from .ref import aio_quant_ref, quant_edge_rows  # noqa: F401
from . import contract  # noqa: F401  (registers the launch contracts)
