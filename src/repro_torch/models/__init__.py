"""The dense decoder model: layers, attention with KV caches, transformer."""
from .transformer import (ModelConfig, Transformer, decode_step, forward,  # noqa: F401
                          init_caches, init_params, reset_slots)
