"""The plain PyTorch version of every kernel, under the names of
``repro.kernels.ref``.  Each is defined beside its kernel; this module only
gathers them."""
from .copy_stream import plain as copy
from .flash_attention import plain as attention
from .matmul import plain as matmul
from .sort_bitonic import plain as sort_rows

__all__ = ["attention", "copy", "matmul", "sort_rows"]
