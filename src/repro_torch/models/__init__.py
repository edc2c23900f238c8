"""The dense decoder model: layers, attention with KV caches, transformer."""
from .layers import QuantPolicy  # noqa: F401
from .transformer import (ModelConfig, Transformer, decode_step, forward,  # noqa: F401
                          init_caches, init_params, quantize_params,
                          reset_slots, resident_format)
