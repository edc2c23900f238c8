"""The grouped GEMM (the morphable multi-tenant MAC plane): its CUDA kernel
wrapper and plain version, the reference, tenant packing and the registry
impls."""
from . import ops  # noqa: F401  (registers the grouped_matmul impls)
from .kernel import (grouped_matmul, grouped_matmul_plain,  # noqa: F401
                     grouped_plan)
from .ops import (make_group_ids, multi_gemm_with_policy,  # noqa: F401
                  pack_tenants)
from .ref import grouped_matmul_ref  # noqa: F401
from . import contract  # noqa: F401  (registers the launch contracts)
