"""The depthwise conv: its CUDA kernel wrapper and plain version, the
reference and the registry impls."""
from . import ops  # noqa: F401  (registers the depthwise_conv impls)
from .kernel import depthwise_conv, depthwise_plain  # noqa: F401
from .ref import depthwise_ref  # noqa: F401
from . import contract  # noqa: F401  (registers the launch contracts)
