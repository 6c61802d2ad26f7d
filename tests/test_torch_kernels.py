"""The port's kernel ops against the JAX package's Pallas kernels.

On the CPU the port's ops take their plain PyTorch versions; the JAX side runs
the Pallas kernel bodies in interpret mode, as tests/test_kernels.py does.
Both get the same numpy arrays.  Tolerances are those of test_kernels.py:
matmul rtol=tol, atol=10*tol with tol 5e-5 for fp32 (summation order) and
2e-2 for bf16 (one bf16 rounding of the output); copy and sort exact.
"""
import ctypes
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import _build, launch_counts, ops, ref
from repro_torch.kernels import copy_stream, matmul, sort_bitonic


def _pair(shape, dtype: str, seed: int):
    """The same numpy array as a torch tensor and a jax array."""
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        a = rng.integers(0, 100, shape, dtype=np.int32)
    else:
        a = rng.standard_normal(shape).astype(np.float32)
    return (torch.from_numpy(a).to(getattr(torch, dtype)),
            jnp.asarray(a, getattr(jnp, dtype)))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


# ---------------------------------------------------------------- matmul --
@pytest.mark.parametrize("dtype,tol", [("float32", 5e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("m,k,n,bm,bn,bk", [
    (128, 128, 128, 128, 128, 128),
    (256, 384, 256, 128, 128, 128),
    (256, 256, 512, 128, 256, 64),
    (512, 128, 128, 256, 128, 128),
])
def test_matmul_matches_pallas(m, k, n, bm, bn, bk, dtype, tol):
    x, xj = _pair((m, k), dtype, 1)
    y, yj = _pair((k, n), dtype, 2)
    got = ops.matmul(x, y, bm=bm, bn=bn, bk=bk)
    want = jops.matmul(xj, yj, bm=bm, bn=bn, bk=bk, force="interpret")
    assert got.dtype == x.dtype and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol, atol=10 * tol)


def test_matmul_out_dtype_matches_pallas():
    """fp32 output of bf16 operands: only the summation order differs."""
    x, xj = _pair((128, 256), "bfloat16", 3)
    y, yj = _pair((256, 128), "bfloat16", 4)
    got = ops.matmul(x, y, out_dtype=torch.float32)
    want = jops.matmul(xj, yj, out_dtype=jnp.float32, force="interpret")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-5,
                               atol=5e-4)


# ------------------------------------------------------------------ copy --
@pytest.mark.parametrize("shape,block", [((256, 128), 256), ((512, 64), 128),
                                         ((1024, 256), 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_copy_matches_pallas(shape, block, dtype):
    x, xj = _pair(shape, dtype, 5)
    got = ops.copy(x, block_rows=block)
    want = jops.copy(xj, block_rows=block, force="interpret")
    np.testing.assert_array_equal(_np(got), np.asarray(want, _np(x).dtype))
    assert torch.equal(got, x) and got.dtype == x.dtype
    assert got.untyped_storage().data_ptr() != x.untyped_storage().data_ptr()


# ------------------------------------------------------------------ sort --
@pytest.mark.parametrize("rows,n,block", [(8, 64, 8), (16, 256, 8),
                                          (32, 1024, 4), (8, 128, 2)])
def test_sort_matches_pallas(rows, n, block):
    x, xj = _pair((rows, n), "float32", 6)
    got = ops.sort_rows(x, block_rows=block)
    want = jops.sort_rows(xj, block_rows=block, force="interpret")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.sort(x.numpy(), axis=-1))


# ---------------------------------------------------------------- checks --
_F32 = "float32"
_BAD_CASES = {
    "matmul-contracting": (
        lambda: ops.matmul(_pair((128, 128), _F32, 0)[0],
                           _pair((256, 128), _F32, 0)[0]),
        lambda: jops.matmul(_pair((128, 128), _F32, 0)[1],
                            _pair((256, 128), _F32, 0)[1], force="interpret")),
    "matmul-untiled": (
        lambda: ops.matmul(_pair((100, 128), _F32, 0)[0],
                           _pair((128, 128), _F32, 0)[0]),
        lambda: jops.matmul(_pair((100, 128), _F32, 0)[1],
                            _pair((128, 128), _F32, 0)[1], force="interpret")),
    "copy-block-rows": (
        lambda: ops.copy(_pair((100, 128), _F32, 0)[0]),
        lambda: jops.copy(_pair((100, 128), _F32, 0)[1], force="interpret")),
    "sort-block-rows": (
        lambda: ops.sort_rows(_pair((12, 64), _F32, 0)[0]),
        lambda: jops.sort_rows(_pair((12, 64), _F32, 0)[1],
                               force="interpret")),
    "sort-not-power-of-two": (
        lambda: ops.sort_rows(_pair((8, 100), _F32, 0)[0]),
        lambda: jops.sort_rows(_pair((8, 100), _F32, 0)[1],
                               force="interpret")),
}


@pytest.mark.parametrize("case", sorted(_BAD_CASES))
def test_rejects_what_the_pallas_kernel_rejects(case):
    port, jax_side = _BAD_CASES[case]
    with pytest.raises(ValueError):
        jax_side()
    with pytest.raises(ValueError):
        port()


def test_ref_is_the_bare_plain_version():
    """force='ref' skips the tiling checks, as the JAX oracle path does."""
    x, y = _pair((100, 96), _F32, 7)[0], _pair((96, 80), _F32, 8)[0]
    torch.testing.assert_close(ops.matmul(x, y, force="ref"),
                               ref.matmul(x, y), rtol=0, atol=0)
    s = _pair((3, 100), _F32, 9)[0]
    assert torch.equal(ops.sort_rows(s, force="ref"), torch.sort(s).values)


@pytest.mark.parametrize("op", ["matmul", "copy", "sort_rows"])
def test_force_cuda_on_a_cpu_tensor_raises(op):
    x = _pair((256, 128), _F32, 0)[0]
    args = (x, x.T.contiguous()) if op == "matmul" else (x,)
    with pytest.raises(ValueError, match="CUDA"):
        getattr(ops, op)(*args, force="cuda")
    with pytest.raises(ValueError):
        getattr(ops, op)(*args, force="interpret")


@pytest.mark.parametrize("call", [
    lambda x: matmul.matmul(x, x), lambda x: copy_stream.copy(x),
    lambda x: sort_bitonic.sort_rows(x)])
def test_kernel_wrappers_refuse_cpu_tensors_and_count_nothing(call):
    before = launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        call(torch.zeros((128, 128)))
    assert launch_counts() == before


def test_cpu_tensors_take_the_plain_version_without_launching():
    before = launch_counts()
    x = _pair((256, 128), _F32, 10)[0]
    ops.matmul(x, x.T.contiguous())
    ops.copy(x)
    ops.sort_rows(x)
    assert launch_counts() == before


def test_impl_registry():
    names = [im.name for im in ops.available_impls()]
    assert names == ["ref"] + (["cuda"] if torch.cuda.is_available() else [])
    assert [im.name for im in ops.all_impls()] == ["ref", "cuda"]
    assert ops.op_names() == ("matmul", "copy", "triad", "sort_rows",
                              "rmsnorm", "flash_attention")
    assert ops.op_names() == tuple(jops._OPS)
    x = _pair((256, 128), _F32, 11)[0]
    assert torch.equal(ops.get_impl("ref").op("copy")(x), x)
    with pytest.raises(KeyError):
        ops.get_impl("pallas")


# ----------------------------------------------------------------- build --
def test_library_name_carries_a_hash_of_the_sources():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("librepro_torch_kernels_")
    assert path == _build.library_path()            # stable
    assert {p.name for p in _build._sources()} >= {
        "copy_stream.cu", "flash_attention.cu", "matmul.cu", "rmsnorm.cu",
        "sort_bitonic.cu"}


def test_entry_points_pass_pointers_as_void_pointers():
    """Without argtypes ctypes passes a 32-bit int and cuts the pointer."""
    for name, argtypes in _build.SIGNATURES.items():
        assert argtypes[-1] is ctypes.c_void_p, name       # the stream
        assert ctypes.c_void_p in argtypes[:2], name        # the data


def test_launch_counter_loses_no_update_under_contention():
    counter = _build.LaunchCounter()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [counter.add() for _ in range(5000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert counter.count == 16 * 5000
    counter.reset()
    assert counter.count == 0


# ------------------------------------------------- timing yardsticks ------
@pytest.mark.parametrize("s,sk,causal,window", [
    (1024, 1024, True, None), (64, 64, True, None), (100, 70, False, None),
    (512, 256, True, 64), (200, 90, False, 33), (65, 65, True, -2)])
def test_attention_pairs_counts_what_the_mask_lets_through(s, sk, causal,
                                                           window):
    """The work the flash bound counts is the mask of the plain version."""
    from repro_torch.kernel_bench import attention_pairs
    rows, cols = np.arange(s)[:, None], np.arange(sk)[None, :]
    mask = np.ones((s, sk), bool)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    assert attention_pairs(s, sk, causal, window) == int(mask.sum())


def test_bound_is_the_slower_of_bytes_and_operations():
    from repro_torch.kernel_bench import bound
    # the GEMV moves 8.4 MB for 8.4 MFLOP: bytes; 2048^3 the other way
    ms, by = bound(2 * (2048 + 2048 * 2048 + 2048), 2 * 2048 * 2048,
                   torch.bfloat16)
    assert by == "bytes" and ms == pytest.approx(8396800 / 3.35e12 * 1e3)
    ms, by = bound(3 * 2 * 2048 ** 2, 2 * 2048 ** 3, torch.bfloat16)
    assert by == "operations" and ms == pytest.approx(2 * 2048 ** 3
                                                      / 989e12 * 1e3)


@pytest.mark.parametrize("rows,width", [(1, 1), (3, 2), (1, 16), (1024, 4096),
                                        (2, 32768)])
def test_sort_ops_counts_two_per_compare_exchange(rows, width):
    """The bitonic network's work: k outer, j inner from k down to 0, width
    / 2 compare-exchanges a stage, two operations (compare, select) each."""
    from repro_torch.kernel_bench import sort_ops
    exchanges = sum(width // 2 for k in range(width.bit_length() - 1)
                    for _ in range(k + 1))
    assert sort_ops(rows, width) == 2 * rows * exchanges


def test_sort_at_the_mixed_mode_shape_is_bytes_bound():
    from repro_torch.kernel_bench import bound, sort_ops
    nbytes = 2 * 1024 * 4096 * 4
    ms, by = bound(nbytes, sort_ops(1024, 4096), torch.float32)
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3)
