"""repro_torch.data -- the deterministic synthetic token pipeline with host
sharding.  Twin of ``repro.data``; ``make_batch_specs``, the dry run's
stand-in, waits for the dry run's port (ROADMAP.md, Queue 1 item 7)."""
from .pipeline import SyntheticFrames, SyntheticLM

__all__ = ["SyntheticLM", "SyntheticFrames"]
