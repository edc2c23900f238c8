"""Serving attention kernels (flash-decode, varlen flash-prefill; dense and
int8-KV), their plain versions, and the attention registry impls."""
from . import ops  # noqa: F401  (registers the attention impls)
from .decode import (flash_decode, flash_decode_plain, flash_decode_quant,  # noqa: F401
                     flash_decode_quant_plain)
from .prefill import (flash_prefill, flash_prefill_plain,  # noqa: F401
                      flash_prefill_quant, flash_prefill_quant_plain)
from .ref import mha_ref  # noqa: F401

# every kernel wrapper on the serving path; each counts its launches in
# `.launches`
KERNELS = (flash_decode, flash_decode_quant, flash_prefill,
           flash_prefill_quant)
