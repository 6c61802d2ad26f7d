"""The plain PyTorch version of every kernel, under the names of
``repro.kernels.ref``.  Each is defined beside its kernel; this module only
gathers them."""
from .copy_stream import plain as copy
from .matmul import plain as matmul
from .sort_bitonic import plain as sort_rows

__all__ = ["copy", "matmul", "sort_rows"]
