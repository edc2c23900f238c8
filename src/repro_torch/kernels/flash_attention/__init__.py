"""Attention kernels — the full-sequence flash kernel, and the serving
kernels (flash-decode, varlen flash-prefill; dense and int8-KV; flat caches
and paged block pools) — their plain versions, and the attention registry
impls."""
from . import ops  # noqa: F401  (registers the attention impls)
from .decode import (flash_decode, flash_decode_paged,  # noqa: F401
                     flash_decode_paged_plain, flash_decode_paged_quant,
                     flash_decode_paged_quant_plain, flash_decode_plain,
                     flash_decode_quant, flash_decode_quant_plain)
from .prefill import (flash_prefill, flash_prefill_paged,  # noqa: F401
                      flash_prefill_paged_plain, flash_prefill_paged_quant,
                      flash_prefill_paged_quant_plain, flash_prefill_plain,
                      flash_prefill_quant, flash_prefill_quant_plain)
from .full import flash_attention, flash_attention_plain  # noqa: F401
from .ref import chunked_attention, mha_ref  # noqa: F401

# the kernel wrappers of the flat serving path and of the paged one; each
# counts its launches in `.launches`
KERNELS = (flash_decode, flash_decode_quant, flash_prefill,
           flash_prefill_quant)
PAGED_KERNELS = (flash_decode_paged, flash_decode_paged_quant,
                 flash_prefill_paged, flash_prefill_paged_quant)
from . import contract  # noqa: F401  (registers the launch contracts)
