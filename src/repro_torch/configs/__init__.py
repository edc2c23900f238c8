"""Architecture configs of the ported families: all twelve of the
reference's."""
from .common import (ARCH_IDS, SHAPES, ShapeCell, get_arch,  # noqa: F401
                     get_config, get_smoke, shape_support)
