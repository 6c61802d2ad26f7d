"""The benchmark's yardstick: the card's published peaks and the operations
and bytes that each measured piece of work needs, computed from its shapes.
Rooflines read these and nothing of the program.

Peaks are NVIDIA's data sheet figures for one H100 SXM, dense, at its full
700 W; each run prints the card's power limit beside its numbers.
"""
from __future__ import annotations

import math

PEAK_BF16_FLOPS = 989e12     # FLOP/s, bf16 and fp16 on the tensor cores
PEAK_HBM_BYTES = 3.35e12     # bytes/s of HBM3

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "int32": 4}


def matmul_flops(m: int, k: int, n: int) -> float:
    """(m, k) @ (k, n): one multiply and one add a term."""
    return 2.0 * m * k * n


def io_bytes(shape, dtype: str, *, reads: int = 1, writes: int = 1) -> float:
    """Bytes of ``reads`` inputs and ``writes`` outputs of ``shape``, each
    byte read once or written once."""
    return float(math.prod(shape) * DTYPE_BYTES[dtype] * (reads + writes))


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations at
    the bf16 peak and the bytes at the HBM bandwidth."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def dag_chunk_bound_s(cls: str, shape, dtype: str) -> float:
    """The bound of one chunk of the paper's DAG: matmul x @ x of a square
    operand, a row sort and a copy of ``shape``, each input byte read once
    and each output byte written once (x @ x has one input)."""
    if cls == "matmul":
        n, k = shape
        return bound_s(matmul_flops(n, k, k), io_bytes(shape, dtype))
    if cls in ("sort", "copy"):
        return bound_s(0.0, io_bytes(shape, dtype))
    raise ValueError(f"unknown class {cls!r}")
