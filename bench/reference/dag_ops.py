"""Plain versions of the three TAO classes of the paper's mixed-mode DAG: the
benchmark's own reference for the ``paper-dag`` configuration.  Plain
PyTorch; imports nothing of the program under test.

Each chunk of a TAO computes its class's function of its class's operand:

    matmul  x @ x            (compute-bound; bf16 in, bf16 out)
    sort    each row of x ascending   (data reuse; fp32)
    copy    x into a new buffer       (memory-bound; fp32)

``reference`` gives the exact answer (matmul in fp32 with TF32 off, rounded
to the output's dtype only by the comparison, which reads the error against
the fp32 product).  ``control`` gives the answer computed one precision lower
than the configuration states, the step a faster program might take: the
matmul's operands in float8 e4m3 (a scale per tensor), sort and copy through
bfloat16.
"""
from __future__ import annotations

import torch

FP8_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _matmul_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


@torch.no_grad()
def reference(cls: str, x: torch.Tensor) -> torch.Tensor:
    """The exact answer of one chunk of class ``cls`` on operand ``x``, in
    fp32."""
    xf = x.float()
    if cls == "matmul":
        return _matmul_fp32(xf, xf)
    if cls == "sort":
        return torch.sort(xf, dim=-1).values
    if cls == "copy":
        return xf.clone()
    raise ValueError(f"unknown class {cls!r}")


@torch.no_grad()
def control(cls: str, x: torch.Tensor) -> torch.Tensor:
    """The answer one precision below the configuration's, in fp32."""
    xf = x.float()
    if cls == "matmul":
        q = _fp8(xf)
        return _matmul_fp32(q, q)
    low = xf.to(torch.bfloat16).float()
    if cls == "sort":
        return torch.sort(low, dim=-1).values
    if cls == "copy":
        return low
    raise ValueError(f"unknown class {cls!r}")


@torch.no_grad()
def error(cls: str, out: torch.Tensor, ref: torch.Tensor) -> float:
    """How far ``out`` is from ``ref``: for matmul the largest absolute
    difference over the fp32 product's root mean square (so one element
    rounded wrong shows, and the bf16 rounding of the output is ~2**-9 of an
    element's size); for sort and copy the number of elements that differ
    (an exact comparison)."""
    if out.shape != ref.shape:
        return float("inf")
    o = out.float()
    if cls == "matmul":
        rms = ref.square().mean().sqrt().clamp(min=1e-30)
        return float((o - ref).abs().amax() / rms)
    return float((o != ref).sum())
