"""The AIO multi-format GEMM: its CUDA kernel wrapper and plain version,
the reference, the code-level entries and the matmul registry impls."""
from . import ops  # noqa: F401  (registers the matmul / matmul_codes impls)
from .kernel import (MODES, aio_matmul, aio_matmul_plain,  # noqa: F401
                     gemm_plan)
from .ops import aio_matmul_codes, aio_matmul_resident  # noqa: F401
from .ref import aio_matmul_ref, quantize_operands_ref  # noqa: F401
from . import contract  # noqa: F401  (registers the launch contracts)
