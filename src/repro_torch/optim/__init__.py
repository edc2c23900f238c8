"""AdamW with an f32 master copy, the global-norm clip and the cosine
schedule (`adamw`)."""
from .adamw import (AdamWState, adamw_init, adamw_update,  # noqa: F401
                    clip_by_global_norm, cosine_schedule, global_norm)
