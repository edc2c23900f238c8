"""Architecture configs of the ported (dense) family."""
from .common import ARCH_IDS, get_arch, get_config, get_smoke  # noqa: F401
