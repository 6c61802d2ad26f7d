"""The port's ``rmsnorm`` and ``triad`` ops against the JAX package's Pallas
kernels.

On the CPU the port's ops take their plain PyTorch versions; the JAX side runs
the Pallas kernel bodies in interpret mode, as tests/test_kernels.py does.
Both get the same numpy arrays.  Tolerances are test_kernels.py's: rmsnorm
rtol=atol=2e-5 fp32 (summation order, rsqrt), 2e-2 bf16 (one bf16 rounding of
the output); triad rtol=1e-5, atol=1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro_torch.kernels import copy_stream, launch_counts, ops, ref, rmsnorm
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
    lambda x: copy_stream.triad(2.0, x, x)])
def test_kernel_wrappers_refuse_cpu_tensors_and_count_nothing(call):
    before = launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        call(torch.zeros((128, 128)))
    assert launch_counts() == before


@pytest.mark.parametrize("op", ["rmsnorm", "triad"])
def test_cpu_tensors_take_the_plain_version_and_force_cuda_raises(op):
    x = _pair((256, 128), "float32", 13)[0]
    args = (x, x[0]) if op == "rmsnorm" else (0.5, x, x)
    before = launch_counts()
    got = getattr(ops, op)(*args)
    assert launch_counts() == before
    assert torch.equal(got, getattr(ref, op)(*args))
    with pytest.raises(ValueError, match="CUDA"):
        getattr(ops, op)(*args, force="cuda")


def test_max_width_is_the_register_cache():
    assert rmsnorm.max_width(torch.float32) == 8192
    assert rmsnorm.max_width(torch.bfloat16) == 16384
