"""The port's CUDA kernels against their plain versions on the card, at the
shapes the main path does not reach: tile edges, odd sizes, unaligned
buffers, int32, one-element rows.  Every test here needs a card and is marked
``cuda``; without one they skip.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: matmul rtol=tol, atol=10*tol as in tests/test_kernels.py (tol
5e-5 fp32, 2e-2 bf16); copy and sort bit-exact (sort against torch.sort at
every row length the kernel takes); flash attention
rtol=atol=2e-4 fp32 (summation order), and rtol=1e-2, atol=2e-3 bf16: both
sides compute in fp32 (the kernel carries P as a bf16 high and low part, to
2^-17) and round the output to bf16 once, so they differ by at most one bf16
ulp (2^-7 of the value), as chip_smoke.py holds it.
rmsnorm as tests/test_kernels.py holds the Pallas kernel (rtol=atol=2e-5
fp32, 2e-2 bf16); triad bit-exact (both round the product and the sum one at
a time).  The decoder on the card against the CPU at test_models.py's bf16
formula: rtol 3e-2, atol 4 * 2^-8 * sqrt(4 L + 2); its loss grads at full
width and 2 layers within a relative Frobenius error of 3e-2 a parameter
(bf16 activations summed in another order).
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch import mixed_mode
from repro_torch.configs import get_smoke_config
from repro_torch.models import get_model, hybrid, mamba2, transformer
from repro_torch.models.convert import numpy_params, params_from_numpy
from repro_torch.models.layers import moe_ffn
from repro_torch.core.serve_orchestrator import bursty_serving_trace
from repro_torch.launch import serve, zoo
from repro_torch.workers import ChunkLog
from repro_torch.kernels import (copy_stream, flash_attention,
                                 launch_counts, matmul, ops, rmsnorm,
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


@pytest.mark.parametrize("k,n", [(2048, 2048), (72, 136), (264, 40)])
@pytest.mark.parametrize("m", [1, 2, 8, 16, 17, 64, 127, 129])
def test_matmul_bf16_across_the_small_m_boundary(card, m, k, n):
    """m <= 16 takes the streaming kernel, m > 16 the wgmma one; n and k
    cross the TMA boxes' edges (64 wide) and the 16-column strips."""
    x = _t((m, k), torch.bfloat16, 21, card)
    y = _t((k, n), torch.bfloat16, 22, card)
    for out_dtype in (torch.bfloat16, torch.float32):
        got = matmul.matmul(x, y, out_dtype=out_dtype)
        torch.testing.assert_close(
            got.float(), matmul.plain(x, y, out_dtype=out_dtype).float(),
            rtol=2e-2, atol=0.2)


@pytest.mark.parametrize("m,k,n", [(1024, 2048, 2048), (2048, 2048, 2048)])
def test_matmul_bf16_at_full_size(card, m, k, n):
    x = _t((m, k), torch.bfloat16, 23, card)
    y = _t((k, n), torch.bfloat16, 24, card)
    torch.testing.assert_close(matmul.matmul(x, y).float(),
                               matmul.plain(x, y).float(), rtol=2e-2,
                               atol=0.2)


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


# byte counts at the copy kernel's edges: a * (one unit of 256 vectors on
# each of the grid's blocks) + b.  A batch is 8 vectors a thread, 32768
# bytes a block; a = 8 gives each block one batch, a = 24 three.
COPY_EDGES = [(0, 16), (0, 32752), (0, 32768), (0, 32784), (0, 32791),
              (0, 4096), (0, 4112), (1, -16), (1, 0), (1, 16), (8, -16),
              (8, 0), (8, 16), (24, -16), (24, 5), (24, 16)]


@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("a,b", COPY_EDGES)
def test_copy_kernel_at_span_and_batch_edges(card, a, b, offset):
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    nbytes = a * sms * 4 * 256 * 16 + b
    g = torch.Generator(device=card).manual_seed(nbytes)
    base = torch.randint(0, 256, (nbytes + offset,), dtype=torch.uint8,
                         device=card, generator=g)
    x = base[offset:]
    got = copy_stream.copy(x)
    assert got.data_ptr() != x.data_ptr() and torch.equal(got, x)


def test_copy_kernel_past_2_to_the_31_bytes(card):
    """64-bit offsets: the vectors past byte 2^31 and the 16-byte tail."""
    nbytes = 2 ** 31 + 48
    g = torch.Generator(device=card).manual_seed(0)
    x = torch.randint(0, 256, (nbytes,), dtype=torch.uint8, device=card,
                      generator=g)
    got = copy_stream.copy(x)
    assert got.data_ptr() != x.data_ptr() and torch.equal(got, x)
    del got, x
    torch.cuda.empty_cache()


SORT_LOGS = range(16)  # every row length the kernel takes: 1 .. 32768
# rows 129: not a multiple of the rows a block sorts at any n (128 / (n / E)
# up to n = 1024, then 1)
SORT_ROWS = (1, 3, 129)


def _sort_inputs(n, dtype, device) -> dict:
    """Name -> (rows, n) input: random values, and random 0-1 rows (a
    network that sorts every 0-1 input sorts every input)."""
    rng = np.random.default_rng(n)
    out = {}
    for rows in SORT_ROWS:
        if dtype == torch.int32:
            a = rng.integers(-2 ** 31, 2 ** 31, (rows, n), dtype=np.int64)
        else:
            a = rng.standard_normal((rows, n))
        out[f"random x{rows}"] = a
        out[f"0-1 x{rows}"] = rng.integers(0, 2, (rows, n))
    out["few values x3"] = rng.integers(0, 100, (3, n))
    return {k: torch.from_numpy(np.asarray(v)).to(device=device, dtype=dtype)
            for k, v in out.items()}


def _sort_patterns(n, dtype, device) -> dict:
    """Name -> (rows, n) input: ordered, reversed and tied rows, and the
    type's extremes."""
    up = torch.arange(n, device=device).to(dtype).repeat(3, 1)
    out = {"ordered": up, "reversed": up.flip(-1).contiguous(),
           "tied": torch.ones_like(up), "mod 7": (up % 7).contiguous()}
    if dtype == torch.int32:
        info = torch.iinfo(torch.int32)
        pool = [info.min, info.max, info.min + 1, info.max - 1, 0, -1, 1]
    else:
        pool = [float("-inf"), float("inf"), -3.4e38, 3.4e38, 1.5, -2.0, 0.0]
    rng = np.random.default_rng(n + 1)
    pick = torch.tensor(pool, dtype=dtype, device=device)[
        torch.from_numpy(rng.integers(0, len(pool), (3, n))).to(device)]
    out["extremes"] = pick
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("log2n", SORT_LOGS)
def test_sort_kernel_matches_torch_sort(card, dtype, log2n):
    for name, x in _sort_inputs(1 << log2n, dtype, card).items():
        assert torch.equal(sort_bitonic.sort_rows(x),
                           sort_bitonic.plain(x)), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("log2n", SORT_LOGS)
def test_sort_kernel_on_ordered_and_tied_rows(card, dtype, log2n):
    for name, x in _sort_patterns(1 << log2n, dtype, card).items():
        assert torch.equal(sort_bitonic.sort_rows(x),
                           sort_bitonic.plain(x)), name


def test_sort_kernel_on_an_unaligned_row(card):
    """A view that starts 4 bytes into its buffer takes the scalar loads."""
    base = _t((4 * 2048 + 1,), torch.float32, 8, card)
    x = base[1:].view(4, 2048)
    assert torch.equal(sort_bitonic.sort_rows(x), sort_bitonic.plain(x))


def test_sort_kernel_rejects_rows_beyond_shared_memory(card):
    with pytest.raises(ValueError, match="shared memory"):
        sort_bitonic.sort_rows(_t((1, 65536), torch.float32, 9, card))


@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 2e-4, 2e-4),
                                            (torch.bfloat16, 1e-2, 2e-3)])
@pytest.mark.parametrize("d", flash_attention.HEAD_DIMS)
@pytest.mark.parametrize("b,hq,hkv,s,sk,causal,window", [
    (1, 2, 1, 100, 70, True, None),     # S, Sk not multiples of 64
    (2, 4, 2, 70, 130, False, None),
    (1, 2, 2, 129, 129, True, 1),       # a window of 1: the diagonal only
    (1, 3, 1, 200, 90, False, 33),      # rows past Sk see no key
    (1, 2, 1, 512, 256, True, 64),      # the fault-2 case (ROADMAP Queue 3)
    (1, 1, 1, 65, 65, True, -2),        # nothing visible: all zero
    (4, 32, 8, 64, 64, True, None),     # the decoder's prefill, batch 4
    (2, 32, 8, 63, 63, True, None),     # its teacher-forcing prefill
    (1, 32, 8, 1024, 1024, True, None),  # the zoo's prefill chunk
    (4, 32, 8, 128, 128, True, None),   # a training step (launch.train)
    (2, 32, 8, 128, 128, True, None),   # an orchestrated microbatch
])
def test_flash_kernel_at_tile_edges(card, b, hq, hkv, s, sk, causal, window,
                                    d, dtype, rtol, atol):
    q = _t((b, hq, s, d), dtype, 11, card)
    k = _t((b, hkv, sk, d), dtype, 12, card)
    v = _t((b, hkv, sk, d), dtype, 13, card)
    got = flash_attention.flash_attention(q, k, v, causal=causal,
                                          window=window)
    want = flash_attention.plain(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


def test_flash_kernel_rejects_what_it_does_not_take(card):
    q = _t((1, 2, 64, 64), torch.float32, 14, card)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention.flash_attention(*(3 * [_t((1, 2, 64, 48),
                                                  torch.float32, 15, card)]))
    with pytest.raises(ValueError, match="all float32"):
        flash_attention.flash_attention(q, q.bfloat16(), q.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention.flash_attention(q.transpose(2, 3), q, q)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        flash_attention.flash_attention(
            q, *(2 * [_t((1, 3, 64, 64), torch.float32, 16, card)]))
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention.flash_attention(q, q.cpu(), q)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5),
                                       (torch.bfloat16, 2e-2)])
def test_decode_gemv_at_bm_1(card, dtype, tol):
    """The zoo's decode GEMV: one row through ops.matmul at bm=1, one
    launch a call, the same bits on every call."""
    x = _t((1, 2048), dtype, 17, card)
    w = _t((2048, 2048), dtype, 18, card)
    before = launch_counts()["matmul"]
    got = ops.matmul(x, w, bm=1)
    assert launch_counts()["matmul"] == before + 1
    again = ops.matmul(x, w, bm=1)
    assert launch_counts()["matmul"] == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), matmul.plain(x, w).float(),
                               rtol=tol, atol=10 * tol)


def test_ops_launch_the_kernels_for_cuda_tensors(card):
    before = launch_counts()
    x = _t((256, 128), torch.float32, 10, card)
    ops.matmul(x, x.T.contiguous())
    ops.copy(x)
    ops.sort_rows(x)
    ops.triad(2.0, x, x)
    ops.rmsnorm(x, x[0])
    qkv = x.view(1, 2, 128, 128)
    ops.flash_attention(qkv, qkv, qkv, bq=128, bk=128)
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
    assert {k: after[k] - before[k] for k in after} == {
        "matmul": 10 * 4, "copy": 10 * 4, "triad": 0, "sort_rows": 10 * 4,
        "rmsnorm": 0, "flash_attention": 0}


def test_serving_on_the_card_launches_every_chunk(card):
    """Two kernel tenants at the JAX tenant's shapes serve a short trace:
    every chunk runs once and launches its kernels exactly."""
    tenants = zoo.default_zoo({"steady": "kernel", "burst": "kernel"},
                              shapes=zoo.ZOO_SHAPES)
    zoo.warm_zoo(tenants)
    assert set(launch_counts().values()) == {0}
    trace = bursty_serving_trace(
        n_steady=4, steady_rate=50.0, n_burst=6, burst_at=0.02,
        burst_rate=400.0, steady_prompts=(256, 512), steady_gens=(64,),
        burst_prompts=(1024, 2048), burst_gens=(64, 128), seed=0)
    log = ChunkLog()
    stats = serve.run_zoo(trace, tenants, log=log, timeout_s=120.0)
    assert all(st.done for st in stats.result.per_dag.values())
    prefill = sum(tenants[r.tenant].prefill_chunks(r) for r in trace)
    decode = sum(-(-r.gen_len // 64) for r in trace)
    assert len(log.runs) == prefill + decode
    assert set(log.runs.values()) == {1}
    assert launch_counts() == {"matmul": prefill + decode, "copy": decode,
                               "triad": 0, "sort_rows": 0, "rmsnorm": 0,
                               "flash_attention": prefill}


def test_multi_impl_on_the_card_binds_ref_and_cuda_and_they_agree(card):
    """The card's tenant binds the plain versions ("ref") and the kernels
    ("cuda") as variants, as JAX's registry offers "ref" on every host.  At
    the serving shapes one prefill slab and one decode burst of each agree:
    flash at the bf16 tolerance, the projection and the GEMV at the bf16
    matmul's (2e-2, 10x), the copy bit-exact; "ref" launches no kernel."""
    operands = zoo.kernel_operands_from_numpy(
        zoo.kernel_arrays(zoo.SERVE_SHAPES, seed=5), card)
    tenant = zoo.ZooTenant("t", multi_impl=True, operands=operands)
    assert tuple(tenant._impl_payloads) == ("ref", "cuda")
    q, kv = operands["q"], operands["kv"]
    out, launched = {}, {}
    for name, (pf, df) in tenant._impl_payloads.items():
        im = ops.get_impl(name)
        torch.cuda.synchronize()
        before = launch_counts()
        out[name] = (im.op("flash_attention")(q, kv, kv), pf(), *df())
        torch.cuda.synchronize()
        launched[name] = {k: v - before[k] for k, v in launch_counts().items()
                          if v != before[k]}
    assert launched == {"ref": {}, "cuda": {"flash_attention": 2,
                                            "matmul": 2, "copy": 1}}
    (attn, slab, moved, y), want = out["cuda"], out["ref"]
    torch.testing.assert_close(attn, want[0], rtol=1e-2, atol=2e-3)
    torch.testing.assert_close(slab, want[1], rtol=2e-2, atol=0.2)
    assert torch.equal(moved, want[2])
    assert torch.equal(moved, tenant.cache_slab)
    torch.testing.assert_close(y, want[3], rtol=2e-2, atol=0.2)


# --------------------------------------------------------------- rmsnorm --
@pytest.mark.parametrize("x_dtype,w_dtype,tol", [
    (torch.float32, torch.float32, 2e-5),
    (torch.bfloat16, torch.bfloat16, 2e-2),
    (torch.bfloat16, torch.float32, 2e-2)])     # the model's mix
@pytest.mark.parametrize("rows,d", [(256, 128), (512, 512), (256, 64),
                                    (1, 2048), (4, 2048), (1024, 2048),
                                    (3, 8192), (5, 40), (2, 1000),
                                    (512, 2048),   # a training step's
                                    # mixtral's prefill, decode step and
                                    # teacher forcing; moonshot's prefill
                                    (4352, 6144), (1, 6144), (4360, 6144),
                                    (2048, 2048)])
def test_rmsnorm_kernel_matches_plain(card, rows, d, x_dtype, w_dtype, tol):
    x = _t((rows, d), x_dtype, 20, card)
    w = _t((d,), w_dtype, 21, card)
    got = rmsnorm.rmsnorm(x, w, eps=1e-5)
    want = rmsnorm.plain(x, w, eps=1e-5)
    assert got.dtype == x_dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("x_dtype,w_dtype,tol", [
    (torch.float32, torch.float32, 2e-5),
    (torch.bfloat16, torch.bfloat16, 2e-2),
    (torch.bfloat16, torch.float32, 2e-2)])
@pytest.mark.parametrize("edge", range(12))
def test_rmsnorm_kernel_at_its_geometry_edges(card, edge, x_dtype, w_dtype,
                                              tol):
    """Every d at a warps-per-row step (one vector either side), each at
    every row count around a step of the launch's geometry."""
    d = rmsnorm.geometry_edges(x_dtype)[edge]
    w = _t((d,), w_dtype, 40 + edge, card)
    for rows in rmsnorm.EDGE_ROWS:
        x = _t((rows, d), x_dtype, rows, card)
        got = rmsnorm.rmsnorm(x, w, eps=1e-5)
        torch.testing.assert_close(got.float(),
                                   rmsnorm.plain(x, w, eps=1e-5).float(),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("x_dtype,w_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("rows,d,pieces", [(4000, 3072, 2), (4000, 3072, 16),
                                           (1, 64, 1), (7, 1088, 4),
                                           (33, 8192, 8), (2, 40, 5)])
def test_split_rmsnorm_entry_points_match_plain(card, rows, d, pieces,
                                                x_dtype, w_dtype):
    """``sumsq`` and ``scale`` on the column pieces of (rows, d) against
    their plain versions (fp32 sums at rtol 1e-5; the scale at the whole-row
    kernel's tolerance), and the pieces side by side against the whole-row
    kernel at the same tolerance; each launches once a piece."""
    from repro_torch.kernels import entry_launch_counts

    tol = 2e-5 if x_dtype == torch.float32 else 2e-2
    x = _t((rows, d), x_dtype, 60, card)
    w = _t((d,), w_dtype, 61, card)
    xs = [p.contiguous() for p in x.chunk(pieces, -1)]
    ws = [p.contiguous() for p in w.chunk(pieces)]
    before = entry_launch_counts()
    sums = [rmsnorm.sumsq(p) for p in xs]
    for p, got in zip(xs, sums):
        torch.testing.assert_close(got, rmsnorm.plain_sumsq(p), rtol=1e-5,
                                   atol=0)
    total = torch.stack(sums).sum(0)
    outs = [rmsnorm.scale(p, wp, total, d, eps=1e-5)
            for p, wp in zip(xs, ws)]
    for p, wp, got in zip(xs, ws, outs):
        assert got.dtype == x_dtype and got.shape == p.shape
        torch.testing.assert_close(
            got.float(), rmsnorm.plain_scale(p, wp, total, d, 1e-5).float(),
            rtol=tol, atol=tol)
    torch.testing.assert_close(torch.cat(outs, -1).float(),
                               rmsnorm.rmsnorm(x, w, eps=1e-5).float(),
                               rtol=tol, atol=tol)
    torch.cuda.synchronize()
    after = entry_launch_counts()
    assert all(after[k] == before[k] + len(xs) for k in after)


def test_split_rmsnorm_entry_points_reject_what_they_do_not_take(card):
    x = _t((4, 64), torch.float32, 62, card)
    with pytest.raises(ValueError, match="multiple of 4"):
        rmsnorm.sumsq(x[:, :62].contiguous())
    with pytest.raises(ValueError, match="total"):
        rmsnorm.scale(x, x[0], x[:, 0].contiguous().double(), 64)
    with pytest.raises(ValueError, match="d_full"):
        rmsnorm.scale(x, x[0], x[:, 0].contiguous(), 32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rmsnorm.scale(x, x[0].cpu(), x[:, 0].contiguous(), 64)


def test_rmsnorm_kernel_at_its_widest_rows(card):
    for dtype in (torch.float32, torch.bfloat16):
        d = rmsnorm.max_width(dtype)
        x, w = _t((3, d), dtype, 22, card), _t((d,), torch.float32, 23, card)
        torch.testing.assert_close(rmsnorm.rmsnorm(x, w).float(),
                                   rmsnorm.plain(x, w).float(),
                                   rtol=2e-2, atol=2e-2)
        with pytest.raises(ValueError, match="multiple of"):
            rmsnorm.rmsnorm(_t((1, 2 * d), dtype, 24, card),
                            _t((2 * d,), dtype, 25, card))


def test_rmsnorm_kernel_rejects_what_it_does_not_take(card):
    x = _t((4, 64), torch.float32, 26, card)
    with pytest.raises(ValueError, match="x float32 or bfloat16"):
        rmsnorm.rmsnorm(x.half(), x[0].half())
    with pytest.raises(ValueError, match="x float32 or bfloat16"):
        rmsnorm.rmsnorm(x, x[0].bfloat16())
    with pytest.raises(ValueError, match=r"w \(d,\)"):
        rmsnorm.rmsnorm(x, x[0, :32])
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm.rmsnorm(_t((64, 4), torch.float32, 27, card).T, x[0])
    with pytest.raises(ValueError, match="multiple of 4"):
        rmsnorm.rmsnorm(x[:, :62].contiguous(), x[0, :62].contiguous())
    with pytest.raises(ValueError, match="aligned"):
        flat = _t((4 * 64 + 1,), torch.float32, 28, card)
        rmsnorm.rmsnorm(flat[1:].view(4, 64), x[0])
    with pytest.raises(ValueError, match="CUDA tensors"):
        rmsnorm.rmsnorm(x, x[0].cpu())


def test_no_graph_under_inference_mode(card):
    """Under ``inference_mode`` (every serving step) the ops launch bare:
    no Function, no graph; where a graph is recorded they launch through
    the Function, the same kernel and the same bits, one launch a call."""
    x = _t((4, 2048), torch.bfloat16, 50, card).requires_grad_()
    w = _t((2048,), torch.float32, 51, card).requires_grad_()
    q = _t((2, 32, 64, 64), torch.bfloat16, 52, card).requires_grad_()
    kv = _t((2, 8, 64, 64), torch.bfloat16, 53, card).requires_grad_()
    calls = {"rmsnorm": lambda: ops.rmsnorm(x, w, eps=1e-5, block_rows=4),
             "flash_attention": lambda: ops.flash_attention(q, kv, kv, bq=64,
                                                            bk=64)}
    for name, call in calls.items():
        before = launch_counts()[name]
        with torch.inference_mode():
            bare = call()
        assert bare.grad_fn is None and not bare.requires_grad
        assert torch.is_inference(bare)
        graphed = call()
        assert type(graphed.grad_fn).__name__.endswith("FunctionBackward")
        assert torch.equal(graphed.detach(), bare)
        assert launch_counts()[name] == before + 2


# ----------------------------------------------------------------- triad --
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("a", [0.0, 1.0, -2.5, 0.1])
@pytest.mark.parametrize("numel,offset", [(256 * 128, 0), (1001, 1),
                                          (16384 * 1024, 0), (1, 0)])
def test_triad_kernel_matches_plain_exactly(card, dtype, a, numel, offset):
    base_x = _t((numel + offset,), dtype, 29, card)
    base_y = _t((numel + offset,), dtype, 30, card)
    x, y = base_x[offset:], base_y[offset:]
    got = copy_stream.triad(a, x, y)
    assert got.dtype == dtype and torch.equal(
        got, copy_stream.plain_triad(a, x, y))


def test_triad_kernel_rejects_what_it_does_not_take(card):
    x = _t((8, 64), torch.float32, 31, card)
    with pytest.raises(ValueError, match="shape mismatch"):
        copy_stream.triad(1.0, x, x[:4])
    with pytest.raises(ValueError, match="both float32"):
        copy_stream.triad(1.0, x, x.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        copy_stream.triad(1.0, x.T, x.T)
    with pytest.raises(ValueError, match="CUDA tensors"):
        copy_stream.triad(1.0, x, x.cpu())


# --------------------------------------------------------------- decoder --
def _smoke_hd64():
    """The smoke llama3.2-1b with head_dim 64, a size the flash kernel
    takes (the smoke config's 16 is not)."""
    return dataclasses.replace(get_smoke_config("llama3.2-1b"), head_dim=64)


def _numpy_params(model) -> dict:
    return params_from_numpy(numpy_params(model, seed=0), "cpu")


def test_decoder_on_the_card_matches_the_cpu(card):
    cfg = _smoke_hd64()
    model = get_model(cfg)
    cpu = _numpy_params(model)
    gpu = {k: v.to(card) for k, v in cpu.items()}
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 33)))
    atol = 4 * 2.0 ** -8 * math.sqrt(4 * cfg.n_layers + 2)

    def close(got, want):
        torch.testing.assert_close(got.float().cpu(), want.float(),
                                   rtol=3e-2, atol=atol)

    close(model.forward(gpu, {"tokens": toks.to(card)}),
          model.forward(cpu, {"tokens": toks}))
    pre_g, cache_g = model.prefill(gpu, {"tokens": toks[:, :-1].to(card)})
    pre_c, cache_c = model.prefill(cpu, {"tokens": toks[:, :-1]})
    close(pre_g, pre_c)
    close(cache_g["k"], cache_c["k"])
    dec_g, new_g = model.decode_step(gpu, toks[:, -1:].to(card), cache_g)
    dec_c, _ = model.decode_step(cpu, toks[:, -1:], cache_c)
    close(dec_g, dec_c)
    assert int(new_g["pos"]) == 33 and int(cache_g["pos"]) == 32


def test_decoder_launches_its_kernels_exactly(card):
    cfg = _smoke_hd64()
    model = get_model(cfg)
    weights = model.bf16_copy({k: v.to(card) for k, v in
                               _numpy_params(model).items()})
    toks = torch.zeros((1, 16), dtype=torch.long, device=card)
    norms = 2 * cfg.n_layers + 1
    steps = ((lambda: model.prefill(weights, {"tokens": toks}),
              {"rmsnorm": norms, "flash_attention": cfg.n_layers}),
             (lambda: model.decode_step(weights, toks[:, -1:], cache),
              {"rmsnorm": norms, "flash_attention": 0}),
             (lambda: model.forward(weights, {"tokens": toks}),
              {"rmsnorm": norms, "flash_attention": cfg.n_layers}))
    cache = None
    for step, want in steps:
        before = launch_counts()
        out = step()
        if cache is None:
            cache = out[1]
        torch.cuda.synchronize()
        after = launch_counts()
        assert {k: after[k] - before[k] for k in after} == {
            "matmul": 0, "copy": 0, "triad": 0, "sort_rows": 0, **want}


def test_decoder_loss_grads_on_the_card_match_the_cpu(card):
    """llama3.2-1b at its published widths, cut to 2 layers, one set of
    fp32 weights on the card (the kernels, through their Functions) and on
    the CPU (plain versions): ``loss.backward()`` gives every parameter a
    non-zero grad on the card, within a relative Frobenius error of 3e-2 of
    the CPU's (bf16 activations summed in another order).  The forward
    launches 2L + 1 norms and L attentions, and the backward, recomputing
    each layer (remat, the config's default), 2L and L more."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("llama3.2-1b"), n_layers=2)
    model = get_model(cfg)
    arrays = numpy_params(model, seed=7)
    rng = np.random.default_rng(8)
    toks, tgts = (torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)))
                  for _ in "tt")
    grads = {}
    for dev in (card, torch.device("cpu")):
        params = {k: v.requires_grad_() for k, v in
                  params_from_numpy(arrays, dev).items()}
        before = launch_counts()
        loss, _ = model.loss(params, {"tokens": toks.to(dev),
                                      "targets": tgts.to(dev)})
        loss.backward()
        if dev == card:
            after = launch_counts()
            assert {k: after[k] - before[k] for k in after} == {
                "matmul": 0, "copy": 0, "triad": 0, "sort_rows": 0,
                "rmsnorm": 4 * cfg.n_layers + 1,
                "flash_attention": 2 * cfg.n_layers}
        grads[dev.type] = {k: p.grad.float().cpu() for k, p in params.items()}
        del params
    for name, want in grads["cpu"].items():
        got = grads["cuda"][name]
        assert bool(got.abs().max() > 0), name
        rel = float((got - want).norm() / want.norm())
        assert rel <= 3e-2, (name, rel)


# --------------------------------------- MoE, window and patch decoders --
def test_moe_ffn_on_the_card_syncs_no_host_and_repeats_its_bits(card):
    """moonshot-smoke's moe_ffn (8 experts top-2) at its capacity and at 2,
    where most assignments drop: no call of it waits for the card (sync
    debug mode raises on one), two calls give the same bits, and it agrees
    with the CPU on identical inputs at bf16's rtol = atol = 3e-2."""
    cfg = get_smoke_config("moonshot-v1-16b-a3b")
    m, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    x = _t((3, 33, m), torch.bfloat16, 31, card)
    ws = [_t(shape, torch.float32, 32 + i, card) * scale for i, (shape, scale)
          in enumerate((((m, e), 0.2), ((e, m, f), 0.1), ((e, m, f), 0.1),
                        ((e, f, m), 0.1)))]
    for capacity in (cfg.moe_capacity(33), 2):
        kw = dict(n_experts=e, top_k=cfg.experts_per_token,
                  capacity=capacity)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y = moe_ffn(x, *ws, **kw)
            again = moe_ffn(x, *ws, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert torch.equal(y, again)
        want = moe_ffn(x.cpu(), *(w.cpu() for w in ws), **kw)
        torch.testing.assert_close(y.float().cpu(), want.float(), rtol=3e-2,
                                   atol=3e-2)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "moonshot-v1-16b-a3b",
                                  "internvl2-2b"])
def test_moe_window_and_patch_decoders_on_the_card_match_the_cpu(
        card, monkeypatch, arch):
    """The smoke mixtral (window 32), moonshot and internvl2 (patch
    frontend) at head_dim 32 (a size the flash kernel takes), one set of
    numpy weights on the card and the CPU, in fp32 activations: there the
    router picks the same experts on both (in bf16 a near-tie of its logits
    may go either way).  forward over 41 tokens, prefill of 40 and 4 decode
    steps (mixtral: past its window, through the shifted and the ring
    cache) agree at rtol = atol = 1e-3 (fp32 sums in another order), each
    call launching its kernels exactly."""
    monkeypatch.setattr(transformer, "ACT_DTYPE", torch.float32)
    base = dataclasses.replace(get_smoke_config(arch), head_dim=32)
    variants = [base] + ([dataclasses.replace(base, swa_ring_buffer=True)]
                         if base.window else [])
    arrays = numpy_params(get_model(base), seed=4)
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, base.vocab_size, (2, 44)))
    extra = {}
    if base.frontend == "patch":
        extra["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (2, base.n_patches, base.d_model), dtype=np.float32))
    norms, layers = 2 * base.n_layers + 1, base.n_layers

    def on(dev):
        return {k: v.to(dev) for k, v in extra.items()}

    def counted(fn, flash):
        before = launch_counts()
        out = fn()
        torch.cuda.synchronize()
        after = launch_counts()
        assert {k: after[k] - before[k] for k in after} == {
            "matmul": 0, "copy": 0, "triad": 0, "sort_rows": 0,
            "rmsnorm": norms, "flash_attention": flash}
        return out

    def close(got, want):
        torch.testing.assert_close(got.float().cpu(), want.float(),
                                   rtol=1e-3, atol=1e-3)

    cpu = params_from_numpy(arrays, "cpu")
    gpu = params_from_numpy(arrays, card)
    close(counted(lambda: get_model(base).forward(
        gpu, {"tokens": toks[:, :41].to(card), **on(card)}), layers),
        get_model(base).forward(cpu, {"tokens": toks[:, :41], **extra}))
    for cfg in variants:
        model = get_model(cfg)
        pre_g, cache_g = counted(lambda: model.prefill(
            gpu, {"tokens": toks[:, :40].to(card), **on(card)}), layers)
        pre_c, cache_c = model.prefill(cpu, {"tokens": toks[:, :40],
                                             **extra})
        close(pre_g, pre_c)
        for i in range(40, 44):
            dec_g, cache_g = counted(lambda: model.decode_step(
                gpu, toks[:, i:i + 1].to(card), cache_g), 0)
            dec_c, cache_c = model.decode_step(cpu, toks[:, i:i + 1],
                                               cache_c)
            close(dec_g, dec_c)
            close(cache_g["k"], cache_c["k"])
        assert cache_g["k"].shape[3] == (32 if cfg.window else 40 + 64)


def test_flash_kernel_at_mixtrals_windowed_prefill(card):
    """mixtral-8x22b's prefill attention: q (1, 48, 4352, 128) over kv (1,
    8, 4352, 128), bf16, causal within its 4096-key window, as the decoder
    calls it (bq = bk = S), against the plain version at the bf16
    tolerance of the header."""
    q = _t((1, 48, 4352, 128), torch.bfloat16, 41, card)
    k = _t((1, 8, 4352, 128), torch.bfloat16, 42, card)
    v = _t((1, 8, 4352, 128), torch.bfloat16, 43, card)
    before = launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, window=4096, bq=4352, bk=4352)
    assert launch_counts()["flash_attention"] == before + 1
    want = flash_attention.plain(q, k, v, window=4096)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=2e-3)


@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 2e-4, 2e-4),
                                            (torch.bfloat16, 1e-2, 2e-3)])
@pytest.mark.parametrize("hkv,causal", [(16, False), (4, False), (4, True)])
def test_flash_kernel_at_huberts_encode(card, hkv, causal, dtype, rtol,
                                        atol):
    """hubert-xlarge's encode attention at head dim 80: 4 clips of 500
    frames (not a multiple of the 64-row tile), 16 heads, not causal, as
    the encoder calls it (bq = bk = S); and over 4 kv heads, causal and
    not; each one launch, against the plain version."""
    q = _t((4, 16, 500, 80), dtype, 44, card)
    k = _t((4, hkv, 500, 80), dtype, 45, card)
    v = _t((4, hkv, 500, 80), dtype, 46, card)
    before = launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, bq=500, bk=500)
    assert launch_counts()["flash_attention"] == before + 1
    want = flash_attention.plain(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("x_dtype,w_dtype,tol", [
    (torch.float32, torch.float32, 2e-5),
    (torch.bfloat16, torch.bfloat16, 2e-2),
    (torch.bfloat16, torch.float32, 2e-2)])
@pytest.mark.parametrize("d", [1280, 1536, 1600, 3072])
def test_rmsnorm_kernel_at_the_families_widths(card, d, x_dtype, w_dtype,
                                               tol):
    """hubert's d_model (1280), mamba2's d_model and d_inner (1536, 3072)
    and hymba's d_model and fused width (1600), at every row count around
    a step of the launch's geometry."""
    w = _t((d,), w_dtype, 50, card)
    for rows in rmsnorm.EDGE_ROWS:
        x = _t((rows, d), x_dtype, rows + 51, card)
        torch.testing.assert_close(
            rmsnorm.rmsnorm(x, w, eps=1e-5).float(),
            rmsnorm.plain(x, w, eps=1e-5).float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b",
                                  "hubert-xlarge"])
def test_ssm_hybrid_and_encoder_families_on_the_card_match_the_cpu(
        card, monkeypatch, arch):
    """The smoke mamba2 (chunk 16), hymba (window 32, layer 0 global; at
    head_dim 32, a size the flash kernel takes) and hubert (at head_dim
    80), one set of numpy weights on the card and the CPU, in fp32
    activations.  forward over 41 tokens (frames for hubert): mamba2's
    three chunks and a padded tail, hymba past its window; prefill of 40
    and 4 decode steps (hymba's windowed layer rolling, its global one
    positional) agree at rtol = atol = 1e-3, each call launching its
    kernels exactly; the loss grads within 1e-3 relative Frobenius a
    parameter."""
    for mod in (transformer, mamba2, hybrid):
        monkeypatch.setattr(mod, "ACT_DTYPE", torch.float32)
    cfg = get_smoke_config(arch)
    if cfg.family != "ssm":
        cfg = dataclasses.replace(cfg, head_dim=80 if arch ==
                                  "hubert-xlarge" else 32)
    model = get_model(cfg)
    arrays = numpy_params(model, seed=4)
    rng = np.random.default_rng(5)
    if cfg.frontend == "frames":
        batch = {"frames": torch.from_numpy(rng.standard_normal(
            (2, 41, cfg.d_model), dtype=np.float32))}
    else:
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (2, 44)))}
    batch["targets"] = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (2, 41)))
    L = cfg.n_layers
    norms = (4 if cfg.family == "hybrid" else 2) * L + 1
    flash = 0 if cfg.family == "ssm" else L

    def counted(fn, n_flash):
        before = launch_counts()
        out = fn()
        torch.cuda.synchronize()
        after = launch_counts()
        assert {k: after[k] - before[k] for k in after} == {
            "matmul": 0, "copy": 0, "triad": 0, "sort_rows": 0,
            "rmsnorm": norms, "flash_attention": n_flash}
        return out

    def close(got, want):
        torch.testing.assert_close(got.float().cpu(), want.float(),
                                   rtol=1e-3, atol=1e-3)

    def on(dev, n=41):
        return {k: (v[:, :n] if k != "targets" else v).to(dev)
                for k, v in batch.items()}

    cpu = params_from_numpy(arrays, "cpu")
    gpu = params_from_numpy(arrays, card)
    with torch.inference_mode():
        close(counted(lambda: model.forward(gpu, on(card)), flash),
              model.forward(cpu, on("cpu")))
    if cfg.frontend != "frames":
        pre_g, cache_g = counted(lambda: model.prefill(gpu, on(card, 40)),
                                 flash)
        pre_c, cache_c = model.prefill(cpu, on("cpu", 40))
        close(pre_g, pre_c)
        for i in range(40, 44):
            tok = batch["tokens"][:, i:i + 1]
            dec_g, cache_g = counted(lambda: model.decode_step(
                gpu, tok.to(card), cache_g), 0)
            dec_c, cache_c = model.decode_step(cpu, tok, cache_c)
            close(dec_g, dec_c)
            close(cache_g["ssd"], cache_c["ssd"])
        if cfg.family == "hybrid":
            assert [k.shape[2] for k in cache_g["k"]] == [104, 32]
    grads = {}
    for dev, params in (("cuda", gpu), ("cpu", cpu)):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss, _ = model.loss(leaves, on(dev))
        loss.backward()
        grads[dev] = {k: v.grad for k, v in leaves.items()
                      if v.grad is not None}
    assert set(grads["cuda"]) == set(grads["cpu"])
    for name, want in grads["cpu"].items():
        got = grads["cuda"][name].float().cpu()
        assert float((got - want).norm() / want.norm()) <= 1e-3, name


def test_transformer_tenant_on_the_card_launches_every_chunk(card):
    """The JAX pairing, its transformer tenant at head_dim 64, serves a short
    trace: each prefill chunk launches 2L + 1 norms and L flash attentions,
    each decode step 2L + 1 norms."""
    tenants = {
        "steady": zoo.ZooTenant("steady", flavor="transformer",
                                shapes=zoo.ZOO_SHAPES, config=_smoke_hd64()),
        "burst": zoo.ZooTenant("burst", shapes=zoo.ZOO_SHAPES, seed=1)}
    zoo.warm_zoo(tenants)
    trace = bursty_serving_trace(
        n_steady=4, steady_rate=50.0, n_burst=4, burst_at=0.02,
        burst_rate=400.0, steady_prompts=(256, 1500), steady_gens=(64,),
        burst_prompts=(1024,), burst_gens=(64,), seed=2)
    stats = serve.run_zoo(trace, tenants, log=ChunkLog(), timeout_s=120.0)
    assert all(st.done for st in stats.result.per_dag.values())
    by = {t: [r for r in trace if r.tenant == t] for t in tenants}
    pre = {t: sum(tenants[t].prefill_chunks(r) for r in rs)
           for t, rs in by.items()}
    dec = {t: sum(-(-r.gen_len // 64) for r in rs) for t, rs in by.items()}
    layers = tenants["steady"].config.n_layers
    assert launch_counts() == {
        "matmul": pre["burst"] + dec["burst"], "copy": dec["burst"],
        "triad": 0, "sort_rows": 0,
        "rmsnorm": (2 * layers + 1) * (pre["steady"] + dec["steady"]),
        "flash_attention": pre["burst"] + layers * pre["steady"]}


# -------------------------------------------------------------- training --
def test_train_step_on_the_card_matches_the_cpu(card):
    """Two steps of ``make_train_step`` on the smoke llama3.2-1b at head_dim
    64, one set of fp32 weights on the card (the kernels, through their
    Functions) and on the CPU: loss and grad norm of each step within 3e-2
    relative, every parameter and moment within 3e-2 relative Frobenius
    (bf16 activations summed in another order), and 4L + 1 norms and 2L
    attentions a step: 2L + 1 and L in the forward, and each layer's again
    in the backward's recompute (remat, the config's default)."""
    from repro_torch.data import SyntheticLM
    from repro_torch.models import make_train_step
    from repro_torch.optimizer import adamw_init

    cfg = _smoke_hd64()
    model = get_model(cfg)
    arrays = numpy_params(model, seed=3)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2)
    runs = {}
    for dev in (card, torch.device("cpu")):
        step = make_train_step(model, lr_schedule=1e-3)
        params = params_from_numpy(arrays, dev)
        opt = adamw_init(params)
        before = launch_counts()
        metrics = []
        for s in range(2):
            params, opt, m = step(params, opt, data.batch(s, device=dev))
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
        if dev == card:
            after = launch_counts()
            assert {k: after[k] - before[k] for k in after} == {
                "matmul": 0, "copy": 0, "triad": 0, "sort_rows": 0,
                "rmsnorm": 2 * (4 * cfg.n_layers + 1),
                "flash_attention": 2 * 2 * cfg.n_layers}
        runs[dev.type] = (metrics, {k: v.cpu() for k, v in params.items()},
                          {k: v.cpu() for k, v in opt.mu.items()})
    for got, want in zip(runs["cuda"][0], runs["cpu"][0]):
        np.testing.assert_allclose(got, want, rtol=3e-2)
    for tree in (1, 2):
        for name, want in runs["cpu"][tree].items():
            got = runs["cuda"][tree][name]
            assert float((got - want).norm() / want.norm()) <= 3e-2, name


def test_checkpoint_from_the_card_restores_on_the_cpu(card, tmp_path):
    """A checkpoint written from the card (fp32 params, AdamW state, a bf16
    copy) restores on the CPU, and back onto the card, to equal bytes."""
    from repro_torch.checkpointing import CheckpointManager, Template
    from repro_torch.optimizer import adamw_init

    model = get_model(_smoke_hd64())
    params = {k: v.to(card) for k, v in _numpy_params(model).items()}
    tree = {"params": params, "opt": adamw_init(params),
            "weights": model.bf16_copy(params)}
    tree["opt"].mu["embed.w"].normal_()
    mgr = CheckpointManager(tmp_path)
    mgr.async_save(1, tree)
    mgr.wait()
    like = {"params": {k: Template(tuple(v.shape), v.dtype)
                       for k, v in params.items()},
            "weights": {k: Template(tuple(v.shape), v.dtype)
                        for k, v in tree["weights"].items()},
            "opt": tree["opt"]}
    _, on_cpu = mgr.restore(like)
    for group in ("params", "weights"):
        for k, want in tree[group].items():
            got = on_cpu[group][k]
            assert got.device.type == "cpu" and got.dtype == want.dtype
            assert torch.equal(got, want.cpu()), (group, k)
    # the opt template was the card's tensors: restored onto the card
    assert on_cpu["opt"].step.is_cuda
    for k, want in tree["opt"].mu.items():
        assert torch.equal(on_cpu["opt"].mu[k], want), k
