"""The port's CUDA kernels against their plain versions on the card, at the
shapes the main path does not reach: tile edges, odd sizes, unaligned
buffers, int32, one-element rows.  Every test here needs a card and is marked
``cuda``; without one they skip.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: matmul rtol=tol, atol=10*tol as in tests/test_kernels.py (tol
5e-5 fp32, 2e-2 bf16); copy and sort bit-exact; flash attention
rtol=atol=2e-4 fp32 (summation order), and rtol=1e-2, atol=2e-3 bf16: both
sides compute in fp32 and round the output to bf16 once, so they differ by at
most one bf16 ulp (2^-7 of the value), as chip_smoke.py holds it.
rmsnorm as tests/test_kernels.py holds the Pallas kernel (rtol=atol=2e-5
fp32, 2e-2 bf16); triad bit-exact (both round the product and the sum one at
a time).  The decoder on the card against the CPU at test_models.py's bf16
formula: rtol 3e-2, atol 4 * 2^-8 * sqrt(4 L + 2).
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch import mixed_mode
from repro_torch.configs import get_smoke_config
from repro_torch.models import get_model
from repro_torch.models.convert import numpy_params, params_from_numpy
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
    """The zoo's decode GEMV: one row through ops.matmul at bm=1."""
    x = _t((1, 2048), dtype, 17, card)
    w = _t((2048, 2048), dtype, 18, card)
    before = launch_counts()["matmul"]
    got = ops.matmul(x, w, bm=1)
    assert launch_counts()["matmul"] == before + 1
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


def test_multi_impl_on_the_card_raises(card):
    """The card's registry holds the plain versions ("ref"), which the
    card's path may not schedule."""
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        zoo.ZooTenant("t", multi_impl=True, shapes=zoo.ZOO_SHAPES)


# --------------------------------------------------------------- rmsnorm --
@pytest.mark.parametrize("x_dtype,w_dtype,tol", [
    (torch.float32, torch.float32, 2e-5),
    (torch.bfloat16, torch.bfloat16, 2e-2),
    (torch.bfloat16, torch.float32, 2e-2)])     # the model's mix
@pytest.mark.parametrize("rows,d", [(256, 128), (512, 512), (256, 64),
                                    (1, 2048), (4, 2048), (1024, 2048),
                                    (3, 8192), (5, 40), (2, 1000)])
def test_rmsnorm_kernel_matches_plain(card, rows, d, x_dtype, w_dtype, tol):
    x = _t((rows, d), x_dtype, 20, card)
    w = _t((d,), w_dtype, 21, card)
    got = rmsnorm.rmsnorm(x, w, eps=1e-5)
    want = rmsnorm.plain(x, w, eps=1e-5)
    assert got.dtype == x_dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


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
