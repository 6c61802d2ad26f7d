"""The port's decoder against the JAX package's, on the CPU: the smoke
llama3.2-1b (2 layers, d_model 64, vocab 503 padded to 512) and the other
smoke decoders: chatglm3, minicpm, mixtral (4 experts top-2, window 32),
moonshot (8 experts top-2) and internvl2 (the patch frontend, 8 patches).

JAX initialises the weights (``init(PRNGKey(0))``), which go to numpy and
through ``convert.params_from_numpy`` into the port, so both run the same
weights.  The JAX side runs its plain jnp model, as tests/test_models.py runs
it; the port's kernels take their plain versions on the CPU.  Tolerances:
logits and loss at test_models.py's rtol=atol=3e-2 (bf16 activations, sums in
another order); the KV cache, bf16 values under 1, at one bf16 ulp scale
(rtol 2^-7, atol 2^-8).
"""
import dataclasses
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import get_model as jax_get_model
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.kernels import launch_counts
from repro_torch.launch import serve
from repro_torch.models import (get_model, make_decode_step,
                                make_encode_step, make_prefill_step)
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import apply_rope, rope_freqs

LOGITS = dict(rtol=3e-2, atol=3e-2)
CACHE = dict(rtol=2 ** -7, atol=2 ** -8)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _both(arch: str, **replace):
    """(jax model, jax params, port model, port params) on the same
    weights."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), **replace)
    tcfg = dataclasses.replace(get_smoke_config(arch), **replace)
    jm, tm = jax_get_model(jcfg), get_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    return jm, jp, tm, tp


def _tokens(cfg, b: int, s: int, seed: int = 3):
    t = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))
    return jnp.asarray(t, jnp.int32), torch.from_numpy(t)


def _patches(cfg, b: int, seed: int = 6):
    """The patch frontend's ``patch_embeds`` (B, n_patches, M), fp32 draws
    that both packages cast to bf16, as each package's batch entry; none
    for another frontend."""
    if cfg.frontend != "patch":
        return {}, {}
    pe = np.random.default_rng(seed).standard_normal(
        (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return {"patch_embeds": jnp.asarray(pe)}, \
        {"patch_embeds": torch.from_numpy(pe)}


# (arch, config changes, sequence length): the llama smoke at S = 17 takes
# JAX's dense branch; at dense_attn_max_seq = attn_chunk = 64 and S = 128 its
# q-chunked branch; chatglm3 adds qkv bias and half-dim RoPE, minicpm tied
# embeddings and head_dim 12.  mixtral (window 32) prefills 16 tokens into a
# positional cache and 40 into a rolling one, shifted or a ring buffer;
# moonshot routes 8 experts; internvl2 takes patch_embeds in place of its
# first 8 positions and masks them out of the loss; logits_chunk = 4 takes
# the loss over 4 chunks of the sequence.  The -chunked-skip cases take the
# block-skipping branch (swa_block_skip): the llama smoke at chunk 64 over
# 128 tokens, mixtral at chunk 16 over 80 within its window of 32, where the
# last two chunks skip the keys before 16 and 32 (its prefill of 79 tokens
# falls back to the dense branch, as JAX's does)
CASES = {
    "llama-dense": ("llama3.2-1b", {}, 17),
    "llama-chunked": ("llama3.2-1b", dict(dense_attn_max_seq=64,
                                          attn_chunk=64), 128),
    "chatglm3": ("chatglm3-6b", {}, 17),
    "minicpm": ("minicpm-2b", {}, 17),
    "mixtral-positional": ("mixtral-8x22b", {}, 17),
    "mixtral-rolling": ("mixtral-8x22b", {}, 41),
    "mixtral-ring": ("mixtral-8x22b", dict(swa_ring_buffer=True), 41),
    "moonshot": ("moonshot-v1-16b-a3b", {}, 17),
    "internvl2-patch": ("internvl2-2b", {}, 17),
    "llama-logits-chunk": ("llama3.2-1b", dict(logits_chunk=4), 16),
    "llama-chunked-skip": ("llama3.2-1b", dict(
        dense_attn_max_seq=64, attn_chunk=64, swa_block_skip=True), 128),
    "mixtral-chunked-skip": ("mixtral-8x22b", dict(
        dense_attn_max_seq=16, attn_chunk=16, swa_block_skip=True), 80),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_loss_prefill_and_decode_match_jax(case):
    arch, replace, s = CASES[case]
    jm, jp, tm, tp = _both(arch, **replace)
    tj, tt = _tokens(tm.cfg, 2, s)
    jx, tx = _patches(tm.cfg, 2)
    # forward and loss over the whole sequence
    np.testing.assert_allclose(_np(tm.forward(tp, {"tokens": tt, **tx})),
                               _np(jm.forward(jp, {"tokens": tj, **jx})),
                               **LOGITS)
    jl, jmet = jm.loss(jp, {"tokens": tj, "targets": tj, **jx})
    tl, tmet = tm.loss(tp, {"tokens": tt, "targets": tt, **tx})
    np.testing.assert_allclose(float(tl), float(jl), **LOGITS)
    assert set(tmet) == set(jmet)
    # prefill of all but the last token: last logits and the cache
    jpre, jc = jm.prefill(jp, {"tokens": tj[:, :-1], **jx})
    tpre, tc = tm.prefill(tp, {"tokens": tt[:, :-1], **tx})
    assert tpre.shape == jpre.shape and tc["k"].shape == jc["k"].shape
    np.testing.assert_allclose(_np(tpre), _np(jpre), **LOGITS)
    for name in ("k", "v"):
        assert tc[name].dtype == torch.bfloat16
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), **CACHE)
    assert int(tc["pos"]) == int(jc["pos"]) == s - 1
    # one decode step of the last token: logits and the new cache
    jd, jc2 = jm.decode_step(jp, tj[:, -1:], jc)
    td, tc2 = tm.decode_step(tp, tt[:, -1:], tc)
    np.testing.assert_allclose(_np(td), _np(jd), **LOGITS)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc2[name]), _np(jc2[name]), **CACHE)
    assert int(tc2["pos"]) == int(jc2["pos"]) == s


def test_onehot_cross_entropy_matches_gather():
    jm, jp, tm, tp = _both("llama3.2-1b", ce_onehot=True)
    tj, tt = _tokens(tm.cfg, 2, 17, seed=4)
    gather = get_model(dataclasses.replace(tm.cfg, ce_onehot=False))
    batch = {"tokens": tt, "targets": tt}
    np.testing.assert_allclose(float(tm.loss(tp, batch)[0]),
                               float(gather.loss(tp, batch)[0]), rtol=1e-6)
    np.testing.assert_allclose(
        float(tm.loss(tp, batch)[0]),
        float(jm.loss(jp, {"tokens": tj, "targets": tj})[0]), **LOGITS)


def test_teacher_forcing():
    """The port's own check (test_models.py:86-106): prefill then a decode
    step, through the step builders, give forward's logits at the last two
    positions."""
    cfg = get_smoke_config("llama3.2-1b")
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    _, toks = _tokens(cfg, 2, 17, seed=5)
    full = model.forward(params, {"tokens": toks})
    pre, cache = make_prefill_step(model)(params, {"tokens": toks[:, :-1]})
    dec, cache2 = make_decode_step(model)(params, toks[:, -1:], cache)
    np.testing.assert_allclose(_np(pre[:, 0]), _np(full[:, -2]), **LOGITS)
    np.testing.assert_allclose(_np(dec[:, 0]), _np(full[:, -1]), **LOGITS)
    assert int(cache2["pos"]) == 17 and int(cache["pos"]) == 16
    # the steps run in inference mode whatever the caller's grad mode
    assert torch.is_grad_enabled()
    assert pre.is_inference() and dec.is_inference()
    assert cache2["k"].is_inference()


def test_bf16_copy_changes_no_value():
    _, _, tm, tp = _both("chatglm3-6b")
    copy = tm.bf16_copy(tp)
    assert copy["final_norm.w"] is tp["final_norm.w"]
    assert copy["layers.attn.wq"].dtype == torch.bfloat16
    assert copy["layers.attn.bq"].dtype == torch.bfloat16
    _, tt = _tokens(tm.cfg, 1, 9)
    assert torch.equal(tm.forward(copy, {"tokens": tt}),
                       tm.forward(tp, {"tokens": tt}))


def test_decode_step_is_functional_and_raises_past_the_cache():
    _, _, tm, tp = _both("llama3.2-1b")
    _, tt = _tokens(tm.cfg, 1, 8)
    _, cache = tm.prefill(tp, {"tokens": tt}, max_len=9)
    k0 = cache["k"].clone()
    _, cache2 = tm.decode_step(tp, tt[:, -1:], cache)
    assert torch.equal(cache["k"], k0) and int(cache["pos"]) == 8
    assert not torch.equal(cache2["k"], k0)
    # JAX clamps this write onto the last slot (ROADMAP.md, Queue 3)
    with pytest.raises(ValueError, match="past the cache"):
        tm.decode_step(tp, tt[:, -1:], cache2)


def test_init_is_deterministic_per_generator_seed():
    model = get_model(get_smoke_config("llama3.2-1b"))
    a = model.init(torch.Generator().manual_seed(0))
    b = model.init(torch.Generator().manual_seed(0))
    c = model.init(torch.Generator().manual_seed(1))
    assert list(a) == sorted(model.param_defs())
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed.w"], c["embed.w"])
    assert torch.equal(a["final_norm.w"], torch.ones(64))
    assert a["embed.w"].shape == (512, 64) and a["embed.w"].dtype == \
        torch.float32
    assert abs(float(a["layers.mlp.w1"].std()) - 0.02) < 2e-3


def test_param_counts_match_jax():
    from repro.configs import get_config as jax_get_config
    for arch in ARCH_IDS:
        mine = get_model(get_config(arch))
        theirs = jax_get_model(jax_get_config(arch))
        assert mine.param_count() == theirs.param_count()
        assert mine.active_param_count() == theirs.active_param_count()
        assert {k: (d.shape, d.init) for k, d in
                mine.param_defs().items()} == {
            k: (d.shape, d.init) for k, d in theirs.param_defs().items()}
    assert get_model(get_config("llama3.2-1b")).param_count() == 1498482688
    mixtral = get_model(get_config("mixtral-8x22b"))
    assert mixtral.active_param_count() < mixtral.param_count() / 3


def test_moe_capacity_matches_jax_for_every_config():
    from repro.configs import get_config as jax_get_config
    for arch in ARCH_IDS:
        for mine, theirs in ((get_config(arch), jax_get_config(arch)),
                             (get_smoke_config(arch),
                              jax_smoke_config(arch))):
            if not mine.is_moe:
                continue
            for tokens in (1, 7, 17, 64, 512, 4352):
                assert mine.moe_capacity(tokens) == \
                    theirs.moe_capacity(tokens)
    # the slice's serving shapes: 1360 slots a row at mixtral's prompt of
    # 4352, 64 at moonshot's 512, 8 at a decode step
    assert get_config("mixtral-8x22b").moe_capacity(4352) == 1360
    assert get_config("moonshot-v1-16b-a3b").moe_capacity(512) == 64
    assert get_config("moonshot-v1-16b-a3b").moe_capacity(1) == 8


def test_configs_are_the_jax_packages():
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS
    from repro.configs import get_config as jax_get_config
    assert ARCH_IDS == JAX_ARCH_IDS
    for arch in ARCH_IDS:
        for mine, theirs in ((get_config(arch), jax_get_config(arch)),
                             (get_smoke_config(arch),
                              jax_smoke_config(arch))):
            assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)


def _no_drops(arch: str) -> dict:
    """capacity_factor = n_experts / top_k: a group of S tokens then has S
    slots an expert, so no assignment drops.  forward over S + n tokens
    routes at moe_capacity(S + n) and prefill at moe_capacity(S): where
    assignments drop, the two are other functions, in the reference as much
    as in the port."""
    cfg = get_smoke_config(arch)
    return dict(capacity_factor=cfg.n_experts / cfg.experts_per_token)


@pytest.mark.parametrize("ring", [False, True])
def test_decode_past_the_window_matches_jax_at_every_step(ring):
    """mixtral-smoke (window 32): prefill of 40 tokens into the rolling
    cache, then 8 decode steps, shift-concat or ring buffer
    (test_perf_knobs.py:53): each step's cache equals JAX's to one bf16
    ulp, its logits JAX's and the windowed forward's at 3e-2."""
    jm, jp, tm, tp = _both("mixtral-8x22b", swa_ring_buffer=ring,
                           **_no_drops("mixtral-8x22b"))
    tj, tt = _tokens(tm.cfg, 1, 48, seed=5)
    full = tm.forward(tp, {"tokens": tt})
    _, jc = jm.prefill(jp, {"tokens": tj[:, :40]})
    _, tc = tm.prefill(tp, {"tokens": tt[:, :40]})
    for i in range(40, 48):
        jd, jc = jm.decode_step(jp, tj[:, i:i + 1], jc)
        td, tc = tm.decode_step(tp, tt[:, i:i + 1], tc)
        assert tc["k"].shape == jc["k"].shape == (2, 1, 2, 32, 16)
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), **CACHE)
        assert int(tc["pos"]) == int(jc["pos"]) == i + 1
        np.testing.assert_allclose(_np(td), _np(jd), **LOGITS)
        np.testing.assert_allclose(_np(td[:, 0]), _np(full[:, i]), **LOGITS)


def test_fault_5_a_short_prompt_decodes_past_the_window_unwindowed():
    """ROADMAP.md Queue 3, fault 5: mixtral-smoke (window 32) prefills a
    prompt of 28 tokens into a positional cache of 92 slots, and decode at
    positions 28-43 attends to every cached position, in both packages:
    each step equals the unwindowed forward (window=None) and, from
    position 32 on, departs from the windowed one."""
    jm, jp, tm, tp = _both("mixtral-8x22b", **_no_drops("mixtral-8x22b"))
    toks = jax.random.randint(jax.random.PRNGKey(5), (1, 44), 0,
                              tm.cfg.vocab_size)
    runs = {"jax": (jm, jp, toks, jax_get_model(dataclasses.replace(
                jm.cfg, window=None))),
            "port": (tm, tp, torch.from_numpy(np.array(toks)), get_model(
                dataclasses.replace(tm.cfg, window=None)))}
    for name, (model, params, tokens, unwindowed) in runs.items():
        windowed = _np(model.forward(params, {"tokens": tokens}))
        full = _np(unwindowed.forward(params, {"tokens": tokens}))
        _, cache = model.prefill(params, {"tokens": tokens[:, :28]})
        assert cache["k"].shape[3] == 28 + 64
        dec = []
        for i in range(28, 44):
            lg, cache = model.decode_step(params, tokens[:, i:i + 1], cache)
            dec.append(_np(lg[:, 0]))
        dec = np.stack(dec, axis=1)
        np.testing.assert_allclose(dec, full[:, 28:44], **LOGITS,
                                   err_msg=name)
        np.testing.assert_allclose(dec[:, :4], windowed[:, 28:32], **LOGITS,
                                   err_msg=name)
        past = np.abs(dec[:, 4:] - windowed[:, 32:44]).max(axis=(0, 2))
        assert past.min() > 0.02 and past.max() > 0.06, (name, past)


def test_rope_pairs_interleaved_lanes():
    """Lanes 0 and 1 rotate together (layers.py:58), not 0 and D/2."""
    x = torch.zeros((1, 2, 1, 8))
    x[0, :, 0, 0] = 1.0
    out = apply_rope(x, torch.tensor([0, 1]), theta=10000.0)
    inv = rope_freqs(8, 10000.0)
    assert torch.equal(out[0, 0, 0], x[0, 0, 0])
    np.testing.assert_allclose(out[0, 1, 0, :2].numpy(),
                               [np.cos(float(inv[0])), np.sin(float(inv[0]))],
                               rtol=1e-6)
    assert not out[0, 1, 0, 2:].any()


def test_models_launch_no_kernel_on_the_cpu():
    _, _, tm, tp = _both("llama3.2-1b")
    _, tt = _tokens(tm.cfg, 1, 8)
    before = launch_counts()
    _, cache = tm.prefill(tp, {"tokens": tt})
    tm.decode_step(tp, tt[:, -1:], cache)
    assert launch_counts() == before


# ------------------------------------------------------------- serve CLI --
@pytest.mark.parametrize("orchestrate", [False, True])
def test_serve_arch_runs_on_the_cpu(capsys, orchestrate):
    argv = ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
            "--batch", "2", "--prompt-len", "16", "--gen", "4"]
    serve.main(argv + (["--orchestrate"] if orchestrate else []))
    out = capsys.readouterr().out
    assert "arch=llama3.2-1b-smoke batch=2 prompt=16 gen=4" in out
    assert "prefill:" in out and "decode:" in out
    assert ("orchestrated: 16 TAOs" in out) == orchestrate


def test_serve_arch_runs_the_moe_decoder_on_the_cpu(capsys):
    out = serve.run_arch("mixtral-8x22b", smoke=True, batch=2, prompt_len=40,
                         gen=3, orchestrate=True, device="cpu")
    assert "arch=mixtral-smoke batch=2 prompt=40 gen=3" in \
        capsys.readouterr().out
    # the prompt reaches the window: a rolling cache of 32 slots
    assert out["cache"]["k"].shape[3] == 32
    assert int(out["cache"]["pos"]) == 43
    assert out["stats"].result.completed == 8 * 2
    assert torch.isfinite(out["logits"].float()).all()


def test_orchestrated_serving_keeps_no_weights_once_it_returns():
    """The stats of an orchestrated run keep its DAGs and their payloads;
    the payloads let go of the model once the run is over, so the weights
    live no longer than the caller's own reference to them."""
    out = serve.run_arch("llama3.2-1b", smoke=True, batch=1, prompt_len=8,
                         gen=2, orchestrate=True, device="cpu")
    weights = weakref.ref(out["weights"]["embed.w"])
    cache = weakref.ref(out["cache"]["k"])
    stats = out["stats"]
    del out
    assert weights() is None and cache() is None
    assert stats.result.completed == 8


def test_serve_arch_takes_a_config_in_place_of_the_archs():
    cfg = dataclasses.replace(get_smoke_config("moonshot-v1-16b-a3b"),
                              n_layers=1)
    out = serve.run_arch("moonshot-v1-16b-a3b", config=cfg, batch=2,
                         prompt_len=8, gen=2, device="cpu")
    assert out["model"].cfg is cfg
    assert out["weights"]["layers.moe.experts.w1"].shape[0] == 1
    assert out["weights"]["layers.moe.experts.w1"].dtype == torch.bfloat16
    assert out["weights"]["layers.moe.router"].dtype == torch.float32
    assert out["out_tokens"].shape == (2, 2)


def test_serve_arch_generates_what_the_model_does():
    out = serve.run_arch("llama3.2-1b", smoke=True, batch=2, prompt_len=8,
                         gen=3, device="cpu")
    assert out["out_tokens"].shape == (2, 3)
    # greedy: the first generated token is the argmax of prefill's logits
    assert torch.equal(out["logits"][:, -1].argmax(-1),
                       out["out_tokens"][:, 0])
    assert int(out["cache"]["pos"]) == 8 + 3
    assert out["cache"]["k"].shape[3] == 8 + 3 + 1


# ------------------------------------------ fault C (ROADMAP.md, Queue 3)
@pytest.mark.parametrize("arch", ["llama3.2-1b", "mixtral-8x22b",
                                  "mamba2-780m", "hymba-1.5b"])
def test_fault_C_decode_reads_a_concrete_pos_over_a_meta_cache(arch):
    """A decode cell's stand-ins: meta parameters and cache, and a concrete
    CPU ``pos`` (``configs.decode_pos``) that the step reads on the host.
    Past a positional cache's slots it raises on meta too (fault 3)."""
    from repro_torch.configs import ShapeSpec, decode_pos, input_specs
    cfg = get_smoke_config(arch)
    shape = ShapeSpec("d", "decode", 16, 2)
    model = get_model(cfg)
    params = model.abstract_params()
    specs = input_specs(cfg, shape)
    assert specs["cache"]["pos"].device.type == "cpu"
    logits, cache = make_decode_step(model)(params, specs["tokens"],
                                            specs["cache"])
    assert logits.device.type == "meta"
    assert logits.shape == (2, 1, cfg.padded_vocab)
    assert int(cache["pos"]) == decode_pos(shape) + 1 == 16
    if cfg.family == "ssm":
        return
    past = {**specs["cache"], "pos": torch.tensor(16, dtype=torch.int32)}
    if cfg.window is not None and cfg.window <= 16:
        return  # a rolling cache has no end
    with pytest.raises(ValueError, match="past"):
        make_decode_step(model)(params, specs["tokens"], past)


def test_fault_C_the_loss_on_dtensor_logits_takes_the_onehot_gold():
    """On DTensor logits the cross-entropy takes the one-hot gold logit,
    which shards over the vocab; on one rank of gloo it gives the gather's
    value bit for bit.  A serve step on DTensor parameters runs under
    no_grad (the encode step here), any other under inference mode."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.losses import lm_cross_entropy
    from repro_torch.parallel.sharding import use_sharding

    gen = torch.Generator().manual_seed(0)
    logits = torch.randn(2, 8, 64, generator=gen)
    targets = torch.randint(0, 64, (2, 8), generator=gen)
    want = lm_cross_entropy(logits, targets)
    model = get_model(get_smoke_config("llama3.2-1b"))
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, 503, (2, 4), generator=gen)
    plain = make_encode_step(model)(params, {"tokens": tokens})
    assert plain.is_inference()
    mesh = make_debug_mesh(device_type="cpu")
    try:
        with use_sharding(mesh):
            dl = DTensor.from_local(logits, mesh, [Shard(0), Shard(2)])
            dt = DTensor.from_local(targets, mesh, [Shard(0), Shard(1)])
            got = lm_cross_entropy(dl, dt)
            assert isinstance(got, DTensor)
            assert torch.equal(got.full_tensor(), want)
            rep = [Replicate()] * 2
            dparams = {k: DTensor.from_local(v, mesh, rep)
                       for k, v in params.items()}
            out = make_encode_step(model)(
                dparams, {"tokens": DTensor.from_local(tokens, mesh, rep)})
            assert not out.to_local().is_inference()
            assert torch.equal(out.full_tensor(), plain)
    finally:
        dist.destroy_process_group()
