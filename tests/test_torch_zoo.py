"""The port's serving slice on the CPU: ``flash_attention`` against the JAX
package's Pallas kernel, the kernel tenant against the JAX tenant's ops on
the JAX tenant's own draws, and short threaded serving runs through the
zoo.

On the CPU the port's ops take their plain PyTorch versions; the JAX side
runs the Pallas kernel bodies in interpret mode, as tests/test_kernels.py
does.  Both get the same numpy arrays.  Tolerances are test_kernels.py's:
rtol=atol=2e-4 for fp32 attention (summation order), 5e-2 for bf16 (one
bf16 rounding of the output), matmul rtol=5e-5, atol=5e-4 for fp32.  The
prefill slab sums 256 attention outputs, each within 2e-4, against unit
normal weights: atol=2e-3.  No test here asserts on wall-clock times.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch import zoo as jzoo
from repro_torch.core import hikey960, make_policy
from repro_torch.core.admission import make_gate
from repro_torch.core.serve_orchestrator import (ServeRequest,
                                                 bursty_serving_trace,
                                                 run_serving_workload_threaded)
from repro_torch.kernels import flash_attention, ops, ref
from repro_torch.launch import serve, zoo
from repro_torch.workers import ChunkLog

TOL = {"float32": 2e-4, "bfloat16": 5e-2}


def _pair(shape, dtype: str, seed: int):
    """The same numpy array as a torch tensor and a jax array."""
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (torch.from_numpy(a).to(getattr(torch, dtype)),
            jnp.asarray(a, getattr(jnp, dtype)))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _qkv(b, hq, hkv, s, sk, d, dtype, seed=0):
    return (_pair((b, hq, s, d), dtype, seed),
            _pair((b, hkv, sk, d), dtype, seed + 1),
            _pair((b, hkv, sk, d), dtype, seed + 2))


# ------------------------------------------------------- flash attention --
@pytest.mark.parametrize("b,hq,hkv,d,causal,window,dtype", [
    # the four modes of test_kernels.py::test_flash_attention_modes
    (2, 4, 2, 64, True, None, "float32"),
    (2, 4, 2, 64, False, None, "float32"),
    (2, 4, 2, 64, True, 100, "float32"),
    (2, 4, 2, 64, True, 256, "float32"),
    # its GQA ratios
    (1, 8, 8, 32, True, None, "float32"),
    (1, 8, 4, 32, True, None, "float32"),
    (1, 8, 1, 32, True, None, "float32"),
    # and bf16
    (1, 2, 1, 64, True, None, "bfloat16"),
], ids=["causal", "full", "window100", "window256", "gqa8/8", "gqa8/4",
        "gqa8/1", "bf16"])
def test_flash_attention_matches_pallas(b, hq, hkv, d, causal, window, dtype):
    (q, qj), (k, kj), (v, vj) = _qkv(b, hq, hkv, 256, 256, d, dtype)
    got = ops.flash_attention(q, k, v, causal=causal, window=window, bq=128,
                              bk=128)
    want = jops.flash_attention(qj, kj, vj, causal=causal, window=window,
                                bq=128, bk=128, force="interpret")
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
def test_rows_that_see_no_key_output_zero(causal):
    """(B, H, S, Sk, D) = (1, 2, 512, 256, 64), window 64: rows from 319 on
    see no key.  The port agrees with the oracle on every row and with the
    Pallas kernel on the rows that see a key.  The Pallas kernel outputs the
    mean of v on the blind rows of a visited kv block (319-383), the fault
    recorded in ROADMAP.md Queue 3."""
    (q, qj), (k, kj), (v, vj) = _qkv(1, 2, 1, 512, 256, 64, "float32", 7)
    kw = dict(causal=causal, window=64)
    got = _np(ops.flash_attention(q, k, v, bq=128, bk=128, **kw))
    oracle = _np(jref.attention(qj, kj, vj, **kw))
    pallas = _np(jops.flash_attention(qj, kj, vj, bq=128, bk=128,
                                      force="interpret", **kw))
    rows, cols = np.arange(512)[:, None], np.arange(256)[None, :]
    sees = ((cols <= rows) | (not causal)) & (cols > rows - 64)
    sees = sees.any(axis=1)
    assert np.flatnonzero(~sees)[0] == 319
    np.testing.assert_allclose(got, oracle, rtol=2e-4, atol=2e-4)
    assert not got[:, :, ~sees].any()
    np.testing.assert_allclose(got[:, :, sees], pallas[:, :, sees],
                               rtol=2e-4, atol=2e-4)
    blind_in_visited_block = np.arange(319, 384)
    assert np.abs(pallas[:, :, blind_in_visited_block]).max() > 0.1


@pytest.mark.parametrize("q_shape,kv_shape,bq,bk,match", [
    ((1, 4, 256, 64), (1, 2, 256, 32), 128, 128, "bad kv shapes"),
    ((1, 4, 256, 64), (1, 3, 256, 64), 128, 128, "not a multiple"),
    ((1, 4, 200, 64), (1, 2, 256, 64), 128, 128, "not tiled"),
    ((1, 4, 256, 64), (1, 2, 192, 64), 128, 128, "not tiled"),
])
def test_flash_attention_raises_where_pallas_does(q_shape, kv_shape, bq, bk,
                                                  match):
    q, qj = _pair(q_shape, "float32", 1)
    k, kj = _pair(kv_shape, "float32", 2)
    with pytest.raises(ValueError, match=match):
        jops.flash_attention(qj, kj, kj, bq=bq, bk=bk, force="interpret")
    with pytest.raises(ValueError, match=match):
        ops.flash_attention(q, k, k, bq=bq, bk=bk)
    # the plain version takes what the TPU's tiling refuses
    if match == "not tiled":
        ops.flash_attention(q, k, k, bq=bq, bk=bk, force="ref")


def test_ref_and_registry_name_flash_attention():
    assert ref.attention is flash_attention.plain
    assert "flash_attention" in ops.op_names()
    assert ops.get_impl("ref").op("flash_attention").keywords == {
        "force": "ref"}


# ----------------------------------------------------- the kernel tenant --
def _jax_tenant_arrays(seed: int) -> dict:
    """The JAX kernel tenant's operands (zoo.py:83-90), redone as numpy."""
    B, H, S, D = 1, 4, 256, 64
    k0, k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 4)
    draws = {
        "q": jax.random.normal(k0, (B, H, S, D), jnp.float32),
        "kv": jax.random.normal(k1, (B, H, S, D), jnp.float32),
        "w": jax.random.normal(k2, (H * D, H * D), jnp.float32),
        "cache_slab": jax.random.normal(k3, (4 * S, H * D), jnp.float32),
        "x1": jax.random.normal(k0, (1, H * D), jnp.float32),
    }
    return {name: np.asarray(a) for name, a in draws.items()}


def _tenant(seed: int = 3, **kw) -> tuple:
    arrays = _jax_tenant_arrays(seed)
    operands = zoo.kernel_operands_from_numpy(arrays, "cpu", torch.float32)
    return arrays, zoo.ZooTenant("t", device="cpu", shapes=zoo.ZOO_SHAPES,
                                 operands=operands, **kw)


def test_zoo_shapes_are_the_jax_tenants():
    arrays = _jax_tenant_arrays(0)
    s = zoo.ZOO_SHAPES
    mine = zoo.kernel_arrays(s, seed=0)
    assert {n: a.shape for n, a in mine.items()} == {
        n: a.shape for n, a in arrays.items()}
    assert s.dtype == torch.float32


def test_prefill_slab_matches_the_jax_ops():
    """flash attention, the raw head-mixing reshape, then the projection,
    composed as the JAX tenant composes them (zoo.py:93-96)."""
    arrays, tenant = _tenant()
    q, kv, w = (jnp.asarray(arrays[n]) for n in ("q", "kv", "w"))
    attn = jops.flash_attention(q, kv, kv, force="interpret")
    want = jops.matmul(attn.reshape(256, 256), w, force="interpret")
    got = tenant.prefill_slab()
    assert got.shape == (256, 256)
    err = np.abs(_np(got) - _np(want))
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-3)
    # the reshape is raw: a transpose to (S, H, D) first would differ
    heads_apart = jnp.transpose(attn, (0, 2, 1, 3)).reshape(256, 256) @ w
    assert np.abs(_np(got) - _np(heads_apart)).max() > 100 * err.max()


@pytest.mark.parametrize("decode_steps", [1, 3])
def test_decode_burst_matches_the_jax_ops(decode_steps):
    arrays, tenant = _tenant(decode_steps=decode_steps)
    moved, y = tenant.decode_burst()
    np.testing.assert_array_equal(moved.numpy(), arrays["cache_slab"])
    assert moved.data_ptr() != tenant.cache_slab.data_ptr()
    # the JAX GEMV runs on auto dispatch, which is the oracle on the CPU
    want = jops.matmul(jnp.asarray(arrays["x1"]), jnp.asarray(arrays["w"]))
    np.testing.assert_allclose(y.numpy(), _np(want), rtol=5e-5, atol=5e-4)


@pytest.mark.parametrize("slab_tokens", [256, 1024])
def test_chunks_and_kv_bytes_equal_the_jax_tenants(slab_tokens):
    _, tenant = _tenant(slab_tokens=slab_tokens)
    theirs = jzoo.ZooTenant("t", flavor="kernel", slab_tokens=slab_tokens)
    for prompt in (1, 255, 256, 257, 1023, 1024, 1025, 4096, 8192, 8193):
        r = ServeRequest(0, prompt, 64)
        assert tenant.prefill_chunks(r) == theirs.prefill_chunks(r)
    assert tenant.kv_bytes_per_token() == theirs.kv_bytes_per_token()
    if slab_tokens == 1024:
        assert tenant.kv_bytes_per_token() == 1024.0


def test_serve_shapes_are_llama_widths():
    s = zoo.SERVE_SHAPES
    assert (s.q_heads, s.kv_heads, s.head_dim, s.width) == (32, 8, 64, 2048)
    assert s.seq == 1024 and s.dtype == torch.bfloat16
    # a 4096-token KV cache of 16 layers, K and V, 8 kv heads of 64, bf16
    assert (s.cache_rows, s.cache_cols * 2) == (4 * s.seq, 32 * 1024)


def test_model_flavors_and_the_default_device_raise():
    assert zoo.FLAVORS == jzoo.FLAVORS
    for flavor in zoo.FLAVORS:  # every flavor builds
        assert zoo.ZooTenant("t", flavor=flavor, device="cpu",
                             shapes=zoo.ZOO_SHAPES).flavor == flavor
    with pytest.raises(ValueError, match="unknown flavor"):
        zoo.ZooTenant("t", flavor="moe", device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        zoo.ZooTenant("t", shapes=zoo.ZOO_SHAPES)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--zoo"])


# ------------------------------------------------ threaded serving runs --
KERNEL_TENANTS = {"steady": "kernel", "burst": "kernel"}


def _cpu_zoo(**kw) -> dict:
    return zoo.default_zoo(KERNEL_TENANTS, device="cpu",
                           shapes=zoo.ZOO_SHAPES, **kw)


def _small_trace(seed: int = 0) -> list:
    return bursty_serving_trace(
        n_steady=4, steady_rate=50.0, n_burst=6, burst_at=0.02,
        burst_rate=400.0, steady_prompts=(256, 512), steady_gens=(64,),
        burst_prompts=(1024, 2048), burst_gens=(64, 128), seed=seed)


def test_serving_through_the_zoo_runs_every_chunk_once():
    tenants = _cpu_zoo()
    trace = _small_trace()
    log = ChunkLog()
    stats = serve.run_zoo(trace, tenants, log=log, timeout_s=60.0)
    res = stats.result
    assert res.n_rejected == 0
    assert all(st.done for st in res.per_dag.values())
    want = sum(tenants[r.tenant].prefill_chunks(r) + -(-r.gen_len // 64)
               for r in trace)
    assert len(log.runs) == want and set(log.runs.values()) == {1}
    assert res.completed == sum(1 + -(-r.gen_len // 64) for r in trace)
    assert len(log.records) == res.completed   # one leader update per TAO
    assert stats.tokens_per_s > 0
    assert set(stats.ptt_profiles) == {"prefill", "decode"}


def test_a_gate_rejected_request_never_binds():
    tenants = _cpu_zoo()
    trace = _small_trace(seed=1)
    bound: list = []
    binder = zoo.zoo_binder(tenants)

    def spy(tao, r):
        bound.append(r.id)
        binder(tao, r)

    stats = run_serving_workload_threaded(
        trace, hikey960(), make_policy("molding:weight"), spy,
        timeout_s=60.0,
        admission=make_gate("token-bucket", rate=1.0, burst=1,
                            max_delay=0.0))
    res = stats.result
    rejected = {st.name for st in res.rejected_dags()}
    assert rejected and len(rejected) < len(trace)
    names = {f"req{i}" for i in bound}
    assert not names & rejected
    assert names == {st.name for st in res.admitted_dags()}
    assert all(st.done for st in res.admitted_dags())


def test_multi_impl_binds_the_ref_variant_on_the_cpu():
    arrays, tenant = _tenant(multi_impl=True)
    assert tuple(tenant._impl_payloads) == ("ref",)
    pf, df = tenant._impl_payloads["ref"]
    np.testing.assert_array_equal(pf().numpy(),
                                  tenant.prefill_slab().numpy())
    np.testing.assert_array_equal(df()[0].numpy(), arrays["cache_slab"])
    tenants = _cpu_zoo(multi_impl=True)
    log = ChunkLog()
    stats = serve.run_zoo(_small_trace(), tenants, log=log, timeout_s=60.0)
    assert all(st.done for st in stats.result.per_dag.values())
    assert set(log.runs.values()) == {1}
    cells = [key for typ in ("prefill", "decode")
             for key in stats.ptt_profiles[typ]]
    assert cells and all(len(key) == 3 and key[2] == "ref" for key in cells)


def test_chunk_log_counts_a_leaders_chunks_per_segment():
    """A preempted TAO resumes as a new segment: a leader that ran chunks
    only in an earlier segment ran none in the one it records."""
    from repro_torch.core.dag import TAO
    from repro_torch.core.preemption import ensure_cursor

    class Core:
        def __init__(self):
            self.seen = []

        def record_time(self, tao, leader, width, elapsed):
            self.seen.append((leader, width, elapsed))

    tao, core, log = TAO("prefill", dag_id=3, id=1), Core(), ChunkLog()
    cursor = ensure_cursor(tao)
    log.watch(core)
    log.note(tao, 0)
    log.note(tao, 1)
    core.record_time(tao, 0, 2, 0.5)
    cursor.preemptions += 1          # displaced, then resumed
    core.record_time(tao, 0, 2, 0.25)
    log.note(tao, 2)
    core.record_time(tao, 0, 2, 0.125)
    assert [r.leader_chunks for r in log.records] == [2, 0, 1]
    assert core.seen == [(0, 2, 0.5), (0, 2, 0.25), (0, 2, 0.125)]
    assert log.runs == {(3, 1, 0): 1, (3, 1, 1): 1, (3, 1, 2): 1}


def test_serve_main_runs_the_entry_trace_on_the_cpu(capsys):
    serve.main(["--zoo", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "warming zoo: {'steady': 'transformer', 'burst': 'kernel'}" in out
    assert "zoo: 48 TAOs" in out          # 24 requests, 1 decode burst each
    assert "PTT[prefill]" in out and "PTT[decode]" in out


# ------------------------------------------- the transformer tenant (JAX) --
def _jax_transformer(seed: int = 0):
    """The JAX transformer tenant's model, weights and tokens
    (zoo.py:120-128), the weights as numpy."""
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import get_model as jax_get_model

    model = jax_get_model(jax_smoke_config("llama3.2-1b"))
    params = model.init(jax.random.PRNGKey(seed))
    toks = jax.random.randint(jax.random.PRNGKey(seed + 1), (1, 16), 0,
                              model.cfg.vocab_size)
    return model, params, toks


def _port_transformer(params, toks, **kw):
    from repro_torch.models.convert import params_from_numpy
    return zoo.ZooTenant(
        "steady", flavor="transformer", device="cpu", shapes=zoo.ZOO_SHAPES,
        params=params_from_numpy({k: np.asarray(v) for k, v in
                                  params.items()}, "cpu"),
        tokens=torch.from_numpy(np.array(toks)).long(), **kw)


@pytest.mark.parametrize("decode_steps", [1, 2])
def test_transformer_tenant_matches_the_jax_model(decode_steps):
    """The tenant's prefill slab and decode burst against the JAX model's
    prefill and decode step on the same weights and tokens (zoo.py:129-143),
    at test_models.py's rtol=atol=3e-2."""
    model, params, toks = _jax_transformer()
    tenant = _port_transformer(params, toks, decode_steps=decode_steps)
    assert tenant.config == zoo.model_config("transformer", zoo.ZOO_SHAPES)
    logits, cache0 = model.prefill(params, {"tokens": toks})
    dec, _ = model.decode_step(params, toks[:, -1:], cache0)
    np.testing.assert_allclose(_np(tenant.prefill_slab()), _np(logits),
                               rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(_np(tenant.cache0["k"]), _np(cache0["k"]),
                               rtol=2 ** -7, atol=2 ** -8)
    np.testing.assert_allclose(_np(tenant.decode_burst()), _np(dec),
                               rtol=3e-2, atol=3e-2)
    assert int(tenant.cache0["pos"]) == int(cache0["pos"]) == 16


def test_decode_bursts_on_many_threads_share_one_cache():
    """The burst steps from one fixed cache on every worker thread at once
    (zoo.py:131-143): decode_step leaves the cache as it was."""
    import concurrent.futures

    model, params, toks = _jax_transformer(seed=2)
    tenant = _port_transformer(params, toks)
    k0 = tenant.cache0["k"].clone()
    first = tenant.decode_burst()
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        outs = [f.result(timeout=60) for f in
                [pool.submit(tenant.decode_burst) for _ in range(16)]]
    assert all(torch.equal(o, first) for o in outs)
    assert torch.equal(tenant.cache0["k"], k0)
    assert int(tenant.cache0["pos"]) == 16


def test_default_zoo_is_the_jax_pairing():
    mine = zoo.default_zoo(device="cpu", shapes=zoo.ZOO_SHAPES)
    theirs = jzoo.default_zoo()
    assert {n: t.flavor for n, t in mine.items()} == {
        n: t.flavor for n, t in theirs.items()} == {
        "steady": "transformer", "burst": "kernel"}
    for name, tenant in mine.items():
        assert tenant.kv_bytes_per_token() == \
            theirs[name].kv_bytes_per_token() == 1024.0
        for prompt in (1, 1024, 1025, 8192):
            r = ServeRequest(0, prompt, 64)
            assert tenant.prefill_chunks(r) == \
                theirs[name].prefill_chunks(r)
    assert mine["steady"].tokens.shape == (1, 16)
    assert mine["steady"].config.name == "llama3.2-1b-smoke"


def test_the_jax_pairing_serves_every_request():
    tenants = zoo.default_zoo(device="cpu", shapes=zoo.ZOO_SHAPES)
    zoo.warm_zoo(tenants)
    trace = _small_trace(seed=3)
    log = ChunkLog()
    stats = serve.run_zoo(trace, tenants, log=log, timeout_s=120.0)
    res = stats.result
    assert res.n_rejected == 0 and all(st.done for st in
                                       res.per_dag.values())
    want = sum(tenants[r.tenant].prefill_chunks(r) + -(-r.gen_len // 64)
               for r in trace)
    assert len(log.runs) == want and set(log.runs.values()) == {1}
    assert set(stats.tokens_per_s_by_tenant) == {"steady", "burst"}
