"""Number-format helpers shared by the model and the kernels."""
from .formats import pow2_ceil  # noqa: F401
