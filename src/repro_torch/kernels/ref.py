"""The plain PyTorch version of every kernel, under the names of
``repro.kernels.ref``.  Each is defined beside its kernel; this module only
gathers them."""
from .copy_stream import plain as copy
from .copy_stream import plain_triad as triad
from .flash_attention import plain as attention
from .matmul import plain as matmul
from .rmsnorm import plain as rmsnorm
from .sort_bitonic import plain as sort_rows

__all__ = ["attention", "copy", "matmul", "rmsnorm", "sort_rows", "triad"]
