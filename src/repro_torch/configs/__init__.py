"""Architecture configs of the ported families: all twelve of the
reference's."""
from .common import ARCH_IDS, get_arch, get_config, get_smoke  # noqa: F401
