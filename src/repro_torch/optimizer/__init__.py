"""repro_torch.optimizer -- AdamW, LR schedules (cosine + MiniCPM's WSD),
clipping.  Twin of ``repro.optimizer``."""
from .adamw import (AdamWState, abstract_opt_state, adamw_init, adamw_update,
                    clip_by_global_norm)
from .schedules import constant_lr, cosine_schedule, wsd_schedule

__all__ = [
    "AdamWState", "abstract_opt_state", "adamw_init", "adamw_update", "clip_by_global_norm",
    "constant_lr", "cosine_schedule", "wsd_schedule",
]
