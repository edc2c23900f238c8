"""The dense decoder model: layers, attention with KV caches, transformer."""
from .layers import QuantPolicy  # noqa: F401
from .transformer import (ModelConfig, Transformer,  # noqa: F401
                          copy_pool_blocks, decode_step, forward,
                          init_caches, init_params, loss_fn,
                          quantize_params, reset_slots, resident_format,
                          resident_view, set_block_tables)
