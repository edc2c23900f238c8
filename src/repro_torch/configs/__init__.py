"""Architecture configs of the ported families (dense, gemma2, MoE)."""
from .common import ARCH_IDS, get_arch, get_config, get_smoke  # noqa: F401
