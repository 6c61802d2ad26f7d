"""Row sort: the paper's *data-reuse* class, as a CUDA kernel for Hopper.

Counterpart of the Pallas ``sort_rows`` (src/repro/kernels/sort_bitonic.py:
27-72).  ``sort_rows`` launches ``csrc/sort_bitonic.cu``: a bitonic network
over each row held in registers as int32 keys, 16 elements a thread, with
transposes through shared memory for the stages that span threads.
``plain`` is the same function in PyTorch.  The power-of-two and
``block_rows`` checks of the TPU kernel live in ``ops.sort_rows``.
"""
from __future__ import annotations

import torch

from . import _build

launches = _build.LaunchCounter()

_DTYPE_CODES = {torch.float32: 0, torch.int32: 2}
# dynamic shared memory one block may hold on Hopper: the row must fit
MAX_ROW_BYTES = 232448


def plain(x: torch.Tensor) -> torch.Tensor:
    """Each row sorted ascending."""
    return torch.sort(x, dim=-1).values


def sort_rows(x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream: each row of (rows, n) sorted
    ascending, n a power of two."""
    if x.device.type != "cuda":
        raise ValueError(f"sort kernel takes a CUDA tensor, got {x.device}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"sort kernel takes a contiguous 2-D tensor, got "
                         f"shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"sort kernel takes float32 or int32, not {x.dtype}")
    rows, n = x.shape
    if n & (n - 1):
        raise ValueError(f"row length {n} must be a power of two")
    if n * x.element_size() > MAX_ROW_BYTES:
        raise ValueError(f"row of {n} x {x.element_size()} bytes exceeds the "
                         f"{MAX_ROW_BYTES} bytes of shared memory a block has")
    if rows >= 2 ** 31:
        raise ValueError(f"sort kernel takes fewer than 2**31 rows, got {rows}")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = _build.load()
    code = lib.repro_sort_rows(x.data_ptr(), out.data_ptr(), rows, n,
                               _DTYPE_CODES[x.dtype], x.device.index,
                               torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "sort_rows")
    launches.add()
    return out
