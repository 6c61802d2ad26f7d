"""repro_torch.checkpointing -- save/restore with an async writer and a
manifest, in the JAX package's layout.  Twin of ``repro.checkpointing``."""
from .checkpoint import (CheckpointManager, Template, load_checkpoint,
                         save_checkpoint)

__all__ = ["CheckpointManager", "Template", "load_checkpoint",
           "save_checkpoint"]
