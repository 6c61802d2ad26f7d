"""The port's ``rmsnorm`` and ``triad`` ops against the JAX package's Pallas
kernels.

On the CPU the port's ops take their plain PyTorch versions; the JAX side runs
the Pallas kernel bodies in interpret mode, as tests/test_kernels.py does.
Both get the same numpy arrays.  Tolerances are test_kernels.py's: rmsnorm
rtol=atol=2e-5 fp32 (summation order, rsqrt), 2e-2 bf16 (one bf16 rounding of
the output); triad rtol=1e-5, atol=1e-6.

The norm of a row split across ranks (``rmsnorm_sumsq``, an all-reduce of
the pieces' sums, ``rmsnorm_scale``) recombines to the whole-row norm: fp32
at rtol 1e-5 (the row's sum in another order), bf16 within one bf16 ulp
(that sum moves the fp32 value by a few fp32 ulps, which one rounding to
bf16 can carry across one bf16 step), against the port's whole-row op and
JAX's ``repro.kernels.ref.rmsnorm``; its backward's grads match the whole
row's at fp32 rtol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro_torch.kernels import (copy_stream, entry_launch_counts,
                                 launch_counts, ops, ref, rmsnorm)
from repro_torch.models import layers

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _pair(shape, dtype: str, seed: int, loc: float = 0.0):
    """The same numpy array as a torch tensor and a jax array."""
    a = (loc + np.random.default_rng(seed).standard_normal(shape)
         ).astype(np.float32)
    return (torch.from_numpy(a).to(getattr(torch, dtype)),
            jnp.asarray(a, getattr(jnp, dtype)))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# --------------------------------------------------------------- rmsnorm --
@pytest.mark.parametrize("rows,d,block", [(256, 128, 256), (512, 512, 128),
                                          (256, 64, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_pallas(rows, d, block, dtype):
    (x, xj), (w, wj) = _pair((rows, d), dtype, 1), _pair((d,), dtype, 2)
    got = ops.rmsnorm(x, w, block_rows=block)
    want = jops.rmsnorm(xj, wj, block_rows=block, force="interpret")
    assert got.dtype == x.dtype and got.shape == x.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("rows", [256, 4, 1])
def test_rmsnorm_in_the_models_mix(rows):
    """bf16 activations, fp32 weights, eps 1e-5, all rows in one block: the
    Pallas kernel and the JAX models' own layer agree with the port's op and
    with its model layer."""
    (x, xj), (w, wj) = (_pair((rows, 64), "bfloat16", 3),
                        _pair((64,), "float32", 4, loc=1.0))
    got = ops.rmsnorm(x, w, eps=1e-5, block_rows=rows)
    assert got.dtype == torch.bfloat16
    pallas = jops.rmsnorm(xj, wj, eps=1e-5, block_rows=rows,
                          force="interpret")
    layer = jlayers.rmsnorm(xj, wj, 1e-5)
    for want in (pallas, layer):
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2)
    x3 = x.reshape(1, rows, 64)
    np.testing.assert_array_equal(_np(layers.rmsnorm(x3, w, 1e-5)),
                                  _np(got).reshape(1, rows, 64))


@pytest.mark.parametrize("case", ["w-shape", "untiled-rows"])
def test_rmsnorm_rejects_what_the_pallas_kernel_rejects(case):
    (x, xj) = _pair((100, 64), "float32", 5)
    if case == "w-shape":
        (w, wj), block = _pair((32,), "float32", 6), 100
    else:
        (w, wj), block = _pair((64,), "float32", 6), 64
    with pytest.raises(ValueError):
        jops.rmsnorm(xj, wj, block_rows=block, force="interpret")
    with pytest.raises(ValueError, match="weight shape" if case == "w-shape"
                       else "not divisible"):
        ops.rmsnorm(x, w, block_rows=block)
    # the bare plain version checks nothing, as the JAX oracle path
    if case == "untiled-rows":
        torch.testing.assert_close(ops.rmsnorm(x, w, block_rows=block,
                                               force="ref"),
                                   ref.rmsnorm(x, w), rtol=0, atol=0)


# --------------------------------------------- a row split across ranks --
def _within_one_bf16_ulp(got: torch.Tensor, want: torch.Tensor) -> None:
    """bf16 ``got`` and ``want`` differ by at most one bf16 step of the
    larger magnitude (2^-7 of its power of two: 8 significand bits)."""
    g, w = got.float(), want.float()
    ulp = torch.ldexp(torch.ones_like(w),
                      torch.frexp(torch.maximum(g.abs(), w.abs()))[1] - 8)
    assert bool(((g - w).abs() <= ulp).all()), (g - w).abs().max().item()


def _split_norm(x, w, pieces: int, eps: float):
    """``ops.rmsnorm_sumsq`` on each of ``pieces`` column pieces of x, their
    sums added as an all-reduce would, ``ops.rmsnorm_scale`` on each piece
    by its piece of w, the pieces put back side by side."""
    xs, ws = x.chunk(pieces, dim=-1), w.chunk(pieces)
    total = sum(ops.rmsnorm_sumsq(xp.contiguous()) for xp in xs)
    assert total.dtype == torch.float32 and total.shape == x.shape[:-1]
    return torch.cat([ops.rmsnorm_scale(xp.contiguous(), wp, total,
                                        d_full=x.shape[-1], eps=eps)
                      for xp, wp in zip(xs, ws)], dim=-1)


@pytest.mark.parametrize("pieces", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_split_row_recombines_to_the_whole_row(pieces, dtype):
    """The model's mix (x in ``dtype``, fp32 w, eps 1e-5) at mamba2's
    gated-norm width cut to 256, split into 1, 2 and 4 column pieces."""
    (x, xj), (w, wj) = (_pair((64, 256), dtype, 31),
                        _pair((256,), "float32", 32, loc=1.0))
    before = (launch_counts(), entry_launch_counts())
    got = _split_norm(x, w, pieces, 1e-5)
    assert (launch_counts(), entry_launch_counts()) == before
    assert got.dtype == x.dtype and got.shape == x.shape
    whole = ops.rmsnorm(x, w, eps=1e-5, block_rows=64)
    for want in (whole, jref.rmsnorm(xj, wj, 1e-5)):
        if dtype == "float32":
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                       atol=0)
        else:
            _within_one_bf16_ulp(got, torch.from_numpy(_np(want)))


class _SimulatedAllReduce:
    """A piece's all-reduce of (rows,) sums over the pieces of a row, with
    the pieces run one after another: each call returns the next of
    ``totals``, the sums over all pieces the test computed first, and keeps
    what its own piece put in, which the test then adds up."""

    def __init__(self, totals):
        self.totals, self.sent = list(totals), []

    def __call__(self, t):
        assert t.dtype == torch.float32 and t.dim() == 1
        self.sent.append(t.detach().clone())
        return self.totals[len(self.sent) - 1]


@pytest.mark.parametrize("pieces", [2, 4])
def test_a_split_rows_grads_match_the_whole_rows(pieces):
    """``layers._SplitRMSNorm`` on each column piece, its two all-reduces
    (the forward's sums of squares, the backward's sums of x w g)
    simulated: the pieces' grads of x and w, side by side, against the
    whole row's (``ops.rmsnorm``'s plain version under autograd) at fp32
    rtol 1e-5, and what the pieces sent adds up to what they got."""
    x, w, g = (torch.from_numpy(np.random.default_rng(s).standard_normal(
        shape).astype(np.float32)) for s, shape in
               ((33, (48, 128)), (34, (128,)), (35, (48, 128))))
    w = w + 1.0
    xw, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
    want = torch.autograd.grad(ops.rmsnorm(xw, ww, eps=1e-5, block_rows=48),
                               (xw, ww), g)
    sumsq = (x * x).sum(-1)
    dot = (x * w * g).sum(-1)
    got, reduces = [], []
    for xp, wp, gp in zip(x.chunk(pieces, -1), w.chunk(pieces),
                          g.chunk(pieces, -1)):
        xp, wp = xp.contiguous().requires_grad_(), wp.requires_grad_()
        reduce = _SimulatedAllReduce([sumsq, dot])
        out = layers._SplitRMSNorm.apply(xp, wp, 1e-5, 128, reduce)
        got.append(torch.autograd.grad(out, (xp, wp), gp.contiguous()))
        reduces.append(reduce)
    for k, total in enumerate((sumsq, dot)):
        torch.testing.assert_close(sum(r.sent[k] for r in reduces), total,
                                   rtol=1e-5, atol=1e-5)
    for i, whole in enumerate(want):
        np.testing.assert_allclose(
            torch.cat([p[i] for p in got], dim=-1).numpy(), whole.numpy(),
            rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["w-shape", "total-shape"])
def test_the_split_halves_check_their_shapes(case):
    x = _pair((8, 64), "float32", 36)[0]
    w, total = x[0, :32] if case == "w-shape" else x[0], \
        x[:4, 0] if case == "total-shape" else x[:, 0]
    with pytest.raises(ValueError, match="weight shape" if case == "w-shape"
                       else "total shape"):
        ops.rmsnorm_scale(x, w, total, d_full=128)


# ----------------------------------------------------------------- triad --
@pytest.mark.parametrize("a", [0.0, 1.0, -2.5])
def test_triad_matches_pallas(a):
    (x, xj), (y, yj) = (_pair((256, 128), "float32", 7),
                        _pair((256, 128), "float32", 8))
    got = ops.triad(a, x, y, block_rows=128)
    want = jops.triad(a, xj, yj, block_rows=128, force="interpret")
    assert got.dtype == x.dtype
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("a", [1.0, -2.5, 0.1])
def test_triad_casts_a_to_x_dtype(a):
    """bf16: ``a`` rounds to bf16 first, as ``repro.kernels.ref.triad``
    rounds it; both packages then round the product and the sum."""
    (x, xj), (y, yj) = (_pair((256, 64), "bfloat16", 9),
                        _pair((256, 64), "bfloat16", 10))
    got = ops.triad(a, x, y)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(jref.triad(a, xj, yj)),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("case", ["shape-mismatch", "untiled-rows"])
def test_triad_rejects_what_the_pallas_kernel_rejects(case):
    (x, xj) = _pair((256, 128), "float32", 11)
    (y, yj) = _pair((128, 128) if case == "shape-mismatch" else (256, 128),
                    "float32", 12)
    block = 256 if case == "shape-mismatch" else 100
    with pytest.raises(ValueError):
        jops.triad(1.0, xj, yj, block_rows=block, force="interpret")
    with pytest.raises(ValueError, match="shape mismatch"
                       if case == "shape-mismatch" else "not divisible"):
        ops.triad(1.0, x, y, block_rows=block)


# ----------------------------------------------------- wrappers on the CPU --
@pytest.mark.parametrize("call", [
    lambda x: rmsnorm.rmsnorm(x, x[0]),
    lambda x: copy_stream.triad(2.0, x, x),
    lambda x: rmsnorm.sumsq(x),
    lambda x: rmsnorm.scale(x, x[0], x[:, 0].contiguous(), 256)])
def test_kernel_wrappers_refuse_cpu_tensors_and_count_nothing(call):
    before = launch_counts(), entry_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        call(torch.zeros((128, 128)))
    assert (launch_counts(), entry_launch_counts()) == before


@pytest.mark.parametrize("op", ["rmsnorm", "triad", "rmsnorm_sumsq",
                                "rmsnorm_scale"])
def test_cpu_tensors_take_the_plain_version_and_force_cuda_raises(op):
    x = _pair((256, 128), "float32", 13)[0]
    total = (x * x).sum(-1)
    args, kw, plain = {
        "rmsnorm": ((x, x[0]), {}, lambda: ref.rmsnorm(x, x[0])),
        "triad": ((0.5, x, x), {}, lambda: ref.triad(0.5, x, x)),
        "rmsnorm_sumsq": ((x,), {}, lambda: rmsnorm.plain_sumsq(x)),
        "rmsnorm_scale": ((x, x[0], total), {"d_full": 128},
                          lambda: rmsnorm.plain_scale(x, x[0], total, 128))}[op]
    before = launch_counts(), entry_launch_counts()
    got = getattr(ops, op)(*args, **kw)
    assert (launch_counts(), entry_launch_counts()) == before
    assert torch.equal(got, plain())
    with pytest.raises(ValueError, match="CUDA"):
        getattr(ops, op)(*args, **kw, force="cuda")


def test_max_width_is_the_register_cache():
    assert rmsnorm.max_width(torch.float32) == 8192
    assert rmsnorm.max_width(torch.bfloat16) == 16384
