"""The port's decoder against the JAX package's, on the smoke llama3.2-1b
(2 layers, d_model 64, vocab 503 padded to 512) and its other dense smoke
configs.

JAX initialises the weights (``init(PRNGKey(0))``), which go to numpy and
through ``convert.params_from_numpy`` into the port, so both run the same
weights.  The JAX side runs its plain jnp model, as tests/test_models.py runs
it; the port's kernels take their plain versions on the CPU.  Tolerances:
logits and loss at test_models.py's rtol=atol=3e-2 (bf16 activations, sums in
another order); the KV cache, bf16 values under 1, at one bf16 ulp scale
(rtol 2^-7, atol 2^-8).
"""
import dataclasses

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
                                make_prefill_step)
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


# (arch, config changes, sequence length): the llama smoke at S = 17 takes
# JAX's dense branch; at dense_attn_max_seq = attn_chunk = 64 and S = 128 its
# q-chunked branch; chatglm3 adds qkv bias and half-dim RoPE, minicpm tied
# embeddings and head_dim 12
CASES = {
    "llama-dense": ("llama3.2-1b", {}, 17),
    "llama-chunked": ("llama3.2-1b", dict(dense_attn_max_seq=64,
                                          attn_chunk=64), 128),
    "chatglm3": ("chatglm3-6b", {}, 17),
    "minicpm": ("minicpm-2b", {}, 17),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_loss_prefill_and_decode_match_jax(case):
    arch, replace, s = CASES[case]
    jm, jp, tm, tp = _both(arch, **replace)
    tj, tt = _tokens(tm.cfg, 2, s)
    # forward and loss over the whole sequence
    np.testing.assert_allclose(_np(tm.forward(tp, {"tokens": tt})),
                               _np(jm.forward(jp, {"tokens": tj})), **LOGITS)
    jl, jmet = jm.loss(jp, {"tokens": tj, "targets": tj})
    tl, tmet = tm.loss(tp, {"tokens": tt, "targets": tt})
    np.testing.assert_allclose(float(tl), float(jl), **LOGITS)
    assert set(tmet) == set(jmet)
    # prefill of all but the last token: last logits and the cache
    jpre, jc = jm.prefill(jp, {"tokens": tj[:, :-1]})
    tpre, tc = tm.prefill(tp, {"tokens": tt[:, :-1]})
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
    for arch in ("llama3.2-1b", "llama3-8b", "chatglm3-6b", "minicpm-2b"):
        mine = get_model(get_config(arch))
        theirs = jax_get_model(jax_get_config(arch))
        assert mine.param_count() == theirs.param_count()
        assert {k: d.shape for k, d in mine.param_defs().items()} == {
            k: d.shape for k, d in theirs.param_defs().items()}
    assert get_model(get_config("llama3.2-1b")).param_count() == 1498482688


def test_configs_are_the_jax_packages():
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS
    from repro.configs import get_config as jax_get_config
    assert ARCH_IDS == JAX_ARCH_IDS
    for arch in ARCH_IDS:
        for mine, theirs in ((get_config(arch), jax_get_config(arch)),
                             (get_smoke_config(arch),
                              jax_smoke_config(arch))):
            assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)


@pytest.mark.parametrize("arch,what", [
    ("mixtral-8x22b", "MoE"), ("moonshot-v1-16b-a3b", "MoE"),
    ("internvl2-2b", "frontend"), ("hubert-xlarge", "frontend"),
    ("mamba2-780m", "ssm family"), ("hymba-1.5b", "hybrid family")])
def test_unported_configs_raise(arch, what):
    with pytest.raises(NotImplementedError, match=f"{what}.*Queue 1"):
        get_model(get_smoke_config(arch))


def test_window_and_chunked_loss_raise():
    cfg = get_smoke_config("llama3.2-1b")
    for change, what in ((dict(window=8), "sliding window"),
                         (dict(logits_chunk=4), "logits_chunk")):
        with pytest.raises(NotImplementedError, match=what):
            get_model(dataclasses.replace(cfg, **change))


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


def test_serve_arch_generates_what_the_model_does():
    out = serve.run_arch("llama3.2-1b", smoke=True, batch=2, prompt_len=8,
                         gen=3, device="cpu")
    assert out["out_tokens"].shape == (2, 3)
    # greedy: the first generated token is the argmax of prefill's logits
    assert torch.equal(out["logits"][:, -1].argmax(-1),
                       out["out_tokens"][:, 0])
    assert int(out["cache"]["pos"]) == 8 + 3
    assert out["cache"]["k"].shape[3] == 8 + 3 + 1
