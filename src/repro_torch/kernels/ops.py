"""Public kernel entry points, with the signatures of ``repro.kernels.ops``.

Each op launches its CUDA kernel for a tensor on the card and takes the plain
PyTorch version for a tensor on the CPU.  ``force="ref"`` takes the plain
version on either device, and ``force="cuda"`` insists on the kernel (a CPU
tensor then raises).  There is no fallback: a kernel that fails to build or
launch raises.  The shape checks of the TPU kernels (tiling, ``block_rows``,
power-of-two rows) hold on every path but ``"ref"``, as they do for the
Pallas path of the JAX ops, so the CPU raises what the card would.

Implementation registry
-----------------------
:func:`available_impls` enumerates the interchangeable implementations
(``ref`` and ``cuda``), as ``repro.kernels.ops`` does for its own.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from . import copy_stream as _copy_stream
from . import matmul as _matmul
from . import sort_bitonic as _sort

FORCES = (None, "ref", "cuda")


def _use_kernel(x: torch.Tensor, force: str | None) -> bool:
    if force not in FORCES:
        raise ValueError(f"force must be one of {FORCES}, got {force!r}")
    if force == "cuda" and x.device.type != "cuda":
        raise ValueError(f"force='cuda' needs a CUDA tensor, got one on "
                         f"{x.device}")
    return force != "ref" and x.device.type == "cuda"


def matmul(x, y, *, bm=128, bn=128, bk=128, out_dtype=None, force=None):
    kernel = _use_kernel(x, force)
    if force != "ref":
        m, k = x.shape
        k2, n = y.shape
        if k != k2:
            raise ValueError(f"contracting dims mismatch: {tuple(x.shape)} @ "
                             f"{tuple(y.shape)}")
        if m % bm or n % bn or k % bk:
            raise ValueError(f"shape ({m},{k})x({k},{n}) not tiled by "
                             f"bm={bm}, bn={bn}, bk={bk}")
    if kernel:
        return _matmul.matmul(x, y, out_dtype=out_dtype)
    return _matmul.plain(x, y, out_dtype=out_dtype)


def copy(x, *, block_rows=256, force=None):
    kernel = _use_kernel(x, force)
    if force != "ref" and x.shape[0] % block_rows:
        raise ValueError(f"rows {x.shape[0]} not divisible by block_rows "
                         f"{block_rows}")
    return _copy_stream.copy(x) if kernel else _copy_stream.plain(x)


def sort_rows(x, *, block_rows=8, force=None):
    kernel = _use_kernel(x, force)
    if force != "ref":
        rows, n = x.shape
        if n & (n - 1):
            raise ValueError(f"row length {n} must be a power of two")
        if rows % block_rows:
            raise ValueError(f"rows {rows} not divisible by block_rows "
                             f"{block_rows}")
    return _sort.sort_rows(x) if kernel else _sort.plain(x)


# ---------------------------------------------------------------------------
# implementation registry
# ---------------------------------------------------------------------------
_OPS: dict[str, Callable] = {
    "matmul": matmul,
    "copy": copy,
    "sort_rows": sort_rows,
}


@dataclasses.dataclass(frozen=True)
class KernelImpl:
    """One interchangeable implementation of the kernel library.

    ``force`` is the value the ops understand; ``available`` is the host
    predicate, evaluated at enumeration time."""

    name: str
    force: str | None
    available: Callable[[], bool]

    def op(self, op_name: str) -> Callable:
        """The public op pinned to this implementation."""
        return functools.partial(_OPS[op_name], force=self.force)


_IMPLS = (
    KernelImpl("ref", "ref", lambda: True),
    KernelImpl("cuda", "cuda", torch.cuda.is_available),
)


def all_impls() -> tuple[KernelImpl, ...]:
    """Every registered implementation, available on this host or not."""
    return _IMPLS


def available_impls() -> tuple[KernelImpl, ...]:
    """Implementations whose availability predicate holds on this host, in
    registry order (``ref`` first, always available)."""
    return tuple(im for im in _IMPLS if im.available())


def get_impl(name: str) -> KernelImpl:
    for im in _IMPLS:
        if im.name == name:
            return im
    raise KeyError(f"unknown kernel impl {name!r}; "
                   f"known: {[im.name for im in _IMPLS]}")


def op_names() -> tuple[str, ...]:
    return tuple(_OPS)
