"""repro_torch.data -- the deterministic synthetic token pipeline with host
sharding, and the meta mirror of a batch.  Twin of ``repro.data``."""
from .pipeline import SyntheticFrames, SyntheticLM, make_batch_specs

__all__ = ["SyntheticLM", "SyntheticFrames", "make_batch_specs"]
