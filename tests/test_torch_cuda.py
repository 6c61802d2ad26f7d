"""The port's CUDA kernels against their plain versions on the card, at the
shapes the main path does not reach: tile edges, odd sizes, unaligned
buffers, int32, one-element rows.  Every test here needs a card and is marked
``cuda``; without one they skip.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: matmul rtol=tol, atol=10*tol as in tests/test_kernels.py (tol
5e-5 fp32, 2e-2 bf16); copy and sort bit-exact.
"""
import numpy as np
import pytest
import torch

from repro_torch import mixed_mode
from repro_torch.kernels import (copy_stream, launch_counts, matmul, ops,
                                 sort_bitonic)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _t(shape, dtype, seed, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    if dtype in (torch.int32, torch.uint8):
        a = rng.integers(0, 100, shape).astype(np.int32)
    else:
        a = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("m,k,n", [(70, 40, 72), (200, 72, 136), (1, 8, 8),
                                   (129, 264, 40)])
@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_matmul_kernel_at_tile_edges(card, m, k, n, dtype, tol, out_dtype):
    x, y = _t((m, k), dtype, 1, card), _t((k, n), dtype, 2, card)
    got = matmul.matmul(x, y, out_dtype=out_dtype)
    want = matmul.plain(x, y, out_dtype=out_dtype)
    assert got.dtype == want.dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=10 * tol)


def test_matmul_kernel_rejects_what_it_does_not_take(card):
    x = _t((64, 60), torch.bfloat16, 3, card)
    with pytest.raises(ValueError, match="multiples of 8"):
        matmul.matmul(x, _t((60, 64), torch.bfloat16, 4, card))
    h = _t((64, 64), torch.float16, 5, card)
    with pytest.raises(ValueError, match="float32 or two bfloat16"):
        matmul.matmul(h, h)
    f = _t((64, 64), torch.float32, 6, card)
    with pytest.raises(ValueError, match="contiguous"):
        matmul.matmul(f.T, f)


@pytest.mark.parametrize("dtype,numel,offset", [
    (torch.uint8, 1, 0), (torch.uint8, 17, 0), (torch.uint8, 4099, 3),
    (torch.bfloat16, 1001, 1), (torch.int32, 4100, 1),
    (torch.float32, 1 << 20, 0)])
def test_copy_kernel_on_odd_and_unaligned_buffers(card, dtype, numel, offset):
    base = _t((numel + offset,), dtype, 7, card)
    x = base[offset:].view(1, numel)
    got = copy_stream.copy(x)
    assert torch.equal(got, x)
    assert got.data_ptr() != x.data_ptr()


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("rows,n", [(3, 1), (3, 2), (5, 32), (2, 64),
                                    (4, 2048), (2, 32768)])
def test_sort_kernel_matches_torch_sort(card, dtype, rows, n):
    x = _t((rows, n), dtype, 8, card)
    assert torch.equal(sort_bitonic.sort_rows(x), sort_bitonic.plain(x))


def test_sort_kernel_on_ordered_and_tied_rows(card):
    up = torch.arange(4096, device=card, dtype=torch.float32).repeat(4, 1)
    for x in (up, up.flip(-1).contiguous(), torch.ones_like(up),
              (up % 7).contiguous()):
        assert torch.equal(sort_bitonic.sort_rows(x), sort_bitonic.plain(x))


def test_sort_kernel_rejects_rows_beyond_shared_memory(card):
    with pytest.raises(ValueError, match="shared memory"):
        sort_bitonic.sort_rows(_t((1, 65536), torch.float32, 9, card))


def test_ops_launch_the_kernels_for_cuda_tensors(card):
    before = launch_counts()
    x = _t((256, 128), torch.float32, 10, card)
    ops.matmul(x, x.T.contiguous())
    ops.copy(x)
    ops.sort_rows(x)
    torch.cuda.synchronize()
    after = launch_counts()
    assert all(after[k] == before[k] + 1 for k in after)


def test_mixed_mode_on_the_card_launches_every_chunk(card):
    tiny = {"matmul": (128, 128), "sort": (8, 128), "copy": (256, 128)}
    log = mixed_mode.ChunkLog()
    before = launch_counts()
    out = mixed_mode.run("molding:weight", n_tasks=30, device="cuda",
                         shapes=tiny, timeout_s=120.0, log=log)
    after = launch_counts()
    assert out["completed"] == 30
    assert set(log.runs.values()) == {1}
    assert all(after[k] - before[k] == 10 * 4 for k in after)
