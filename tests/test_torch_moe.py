"""The port's ``moe_ffn`` against the JAX package's
(``repro.models.layers.moe_ffn``), on the CPU, at the smoke MoE configs'
shapes: mixtral-smoke (d_model 64, 4 experts of d_ff 96, top-2) and
moonshot-smoke (d_model 64, 8 experts of d_ff 32, top-2), each at its
configs' capacity for the group and at capacity 2, where most assignments
drop.

Inputs and weights are numpy draws from a seed, the weights fp32 as the
models keep them.  Tolerances: bf16 outputs at rtol = atol = 3e-2 (the
models' logits bound; the two sides round the expert products and the
combine's sum in another order); fp32 outputs at rtol 1e-4 / atol 1e-5.
Grads against ``jax.grad`` of sum(y * ct): fp32 at rtol 1e-4 / atol 1e-5,
bf16 within a relative Frobenius error of 3e-2 a tensor
(tests/test_torch_autograd.py's bounds).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import moe_ffn as jax_moe_ffn
from repro_torch.configs import get_smoke_config
from repro_torch.models.layers import moe_ffn

BF16 = dict(rtol=3e-2, atol=3e-2)
FP32 = dict(rtol=1e-4, atol=1e-5)


def _case(arch: str, b: int, s: int, seed: int = 0):
    """x (B, S, M) and the layer's weights for ``arch``'s smoke config, as
    numpy; router logits are O(1), so ties do not occur."""
    cfg = get_smoke_config(arch)
    m, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, m)).astype(np.float32)
    router = (0.2 * rng.standard_normal((m, e))).astype(np.float32)
    w1, w3 = ((0.1 * rng.standard_normal((e, m, f))).astype(np.float32)
              for _ in "13")
    w2 = (0.1 * rng.standard_normal((e, f, m))).astype(np.float32)
    return cfg, (x, router, w1, w3, w2)


def _run_both(cfg, arrays, capacity: int, dtype: str):
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.experts_per_token,
              capacity=capacity)
    x, *ws = arrays
    jy = jax_moe_ffn(jnp.asarray(x, getattr(jnp, dtype)),
                     *map(jnp.asarray, ws), **kw)
    ty = moe_ffn(torch.from_numpy(x).to(getattr(torch, dtype)),
                 *map(torch.from_numpy, ws), **kw)
    return np.asarray(jy, np.float32), ty.float().numpy()


# (arch, batch, seq, capacity or None for the config's own)
CASES = {
    "mixtral": ("mixtral-8x22b", 2, 17, None),
    "mixtral-cap2": ("mixtral-8x22b", 2, 17, 2),
    "moonshot": ("moonshot-v1-16b-a3b", 2, 17, None),
    "moonshot-cap2": ("moonshot-v1-16b-a3b", 3, 33, 2),
    "moonshot-decode": ("moonshot-v1-16b-a3b", 4, 1, None),
}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_ffn_matches_jax(case, dtype):
    arch, b, s, cap = CASES[case]
    cfg, arrays = _case(arch, b, s)
    capacity = cap or cfg.moe_capacity(s)
    jy, ty = _run_both(cfg, arrays, capacity, dtype)
    assert ty.shape == jy.shape == arrays[0].shape
    np.testing.assert_allclose(ty, jy, **(BF16 if dtype == "bfloat16"
                                          else FP32))
    # the same tokens lose every assignment (output exactly 0)
    np.testing.assert_array_equal((ty == 0).all(-1), (jy == 0).all(-1))
    if cap == 2:
        assert (jy == 0).all(-1).sum() > b * s // 4


def _reference_drops(x, router, top_k: int, capacity: int):
    """(B, S, k) bool: which assignments the capacity drops, computed by
    hand from the rule (rank within expert in token-major order)."""
    logits = np.einsum("bsm,me->bse", x, router)
    b, s, _ = logits.shape
    ids = np.argsort(-logits, axis=-1, kind="stable")[..., :top_k]
    dropped = np.zeros((b, s, top_k), bool)
    for r in range(b):
        seen: dict = {}
        for t in range(s):
            for j in range(top_k):
                e = ids[r, t, j]
                seen[e] = seen.get(e, 0) + 1
                dropped[r, t, j] = seen[e] > capacity
    return dropped


def test_moe_ffn_drops_what_the_capacity_rule_drops():
    """At capacity 2, in the port and in JAX alike, a token all of whose
    assignments drop outputs exactly 0 and one with any kept does not;
    which tokens those are comes from the rule, computed here by hand."""
    cfg, arrays = _case("moonshot-v1-16b-a3b", 3, 33, seed=1)
    dropped = _reference_drops(arrays[0], arrays[1],
                               cfg.experts_per_token, 2)
    jy, ty = _run_both(cfg, arrays, 2, "float32")
    want = dropped.all(-1)
    assert want.any() and not want.all()
    np.testing.assert_array_equal((ty == 0).all(-1), want)
    np.testing.assert_array_equal((jy == 0).all(-1), want)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", ["mixtral", "moonshot-cap2"])
def test_moe_ffn_grads_match_jax_grad(case, dtype):
    arch, b, s, cap = CASES[case]
    cfg, arrays = _case(arch, b, s, seed=2)
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.experts_per_token,
              capacity=cap or cfg.moe_capacity(s))
    ct = np.random.default_rng(3).standard_normal(
        arrays[0].shape).astype(np.float32)
    ins = [torch.from_numpy(arrays[0]).to(getattr(torch, dtype))
           .requires_grad_()]
    ins += [torch.from_numpy(a).requires_grad_() for a in arrays[1:]]
    (moe_ffn(*ins, **kw).float() * torch.from_numpy(ct)).sum().backward()
    jins = [jnp.asarray(arrays[0], getattr(jnp, dtype))]
    jins += [jnp.asarray(a) for a in arrays[1:]]
    jgrads = jax.grad(lambda *a: jnp.sum(
        jax_moe_ffn(*a, **kw).astype(jnp.float32) * ct),
        argnums=tuple(range(5)))(*jins)
    for name, t, g in zip(("x", "router", "w1", "w3", "w2"), ins, jgrads):
        got = t.grad.float().numpy()
        want = np.asarray(g, np.float32)
        assert got.shape == want.shape and np.abs(got).max() > 0, name
        if dtype == "float32":
            np.testing.assert_allclose(got, want, err_msg=name, **FP32)
        else:
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel <= 3e-2, (name, rel)


def test_moe_ffn_is_deterministic_and_row_independent():
    """Two calls give the same bits, and each batch row routes on its own:
    a row's output does not depend on the other rows."""
    cfg, arrays = _case("mixtral-8x22b", 3, 17, seed=4)
    x, *ws = (torch.from_numpy(a) for a in arrays)
    x = x.bfloat16()
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.experts_per_token,
              capacity=cfg.moe_capacity(17))
    y = moe_ffn(x, *ws, **kw)
    assert torch.equal(y, moe_ffn(x, *ws, **kw))
    assert torch.equal(y[1:2], moe_ffn(x[1:2], *ws, **kw))


@pytest.mark.parametrize("profiled", [False, True])
def test_moe_ffn_opens_its_stage_spans_only_under_the_profiler(
        monkeypatch, profiled):
    """The five stage spans that ``trace_main_path --moe-only`` reads are
    opened while a profiler records, and not otherwise; the output is the
    same either way."""
    from repro_torch.models import layers
    cfg, arrays = _case("moonshot-v1-16b-a3b", 2, 9, seed=5)
    x, *ws = (torch.from_numpy(a) for a in arrays)
    x = x.bfloat16()
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.experts_per_token,
              capacity=cfg.moe_capacity(9))
    want = moe_ffn(x, *ws, **kw)
    opened = []
    record = layers.record_function
    monkeypatch.setattr(layers, "record_function",
                        lambda name: opened.append(name) or record(name))
    if profiled:
        with torch.profiler.profile() as prof:
            got = moe_ffn(x, *ws, **kw)
        names = {e.name for e in prof.events()}
    else:
        got, names = moe_ffn(x, *ws, **kw), set()
    stages = [f"moe.{s}" for s in ("router", "sort", "dispatch", "experts",
                                   "combine")]
    assert opened == (stages if profiled else [])
    assert set(stages) <= names if profiled else not names
    assert torch.equal(got, want)
