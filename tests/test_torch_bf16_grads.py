"""Every differentiable layer of the port in bf16 against the JAX layer's
grads, on the CPU: attention (dense causal, windowed and not causal,
q-chunked and block-skipping, groups of 1, 2 and 4 q heads a kv head;
through the plain versions and through ``FlashAttentionFunction``'s dense
and chunk-wise backward), ``rmsnorm`` (the plain version, and
``RMSNormFunction``'s backward), ``apply_rope``, ``swiglu``, ``moe_ffn``,
``lm_cross_entropy`` (``onehot`` off and on), ``ssd_chunked`` and
``causal_conv``.  The JAX side of ``causal_conv`` is the reference's own
lines (src/repro/models/mamba2.py:184-189), which no function holds.

Inputs are numpy draws from a seed, rounded to bf16 once, and both
packages take the same values: activations in bf16, parameters in the
dtype the models hand each layer (fp32 norm weights, router and experts,
bf16 SwiGLU weights, an fp32 dt and SSM parameters).  The grads are those
of sum(out * ct) with an fp32 numpy cotangent.  The truth is the JAX layer
on the same values in fp32.

Bounds, each grad as a relative Frobenius distance:
  * no grad of the port is further from the truth than 1.25 times JAX's;
  * attention, rmsnorm, rope and the loss compute as JAX does (fp32 inside,
    one rounding at the end), so their grads are also within 1e-4 of
    JAX's.  This is what fault E broke: attention's dk and dv were rounded
    to bf16 per q head before the group's sum, and per chunk before the
    chunks' sum, 2.6e-3 to 3.5e-3 from JAX's (ROADMAP.md, Queue 3).
The launches of the Functions' routes are replaced by their plain
versions (there is no card), as tests/test_torch_autograd.py does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_autograd import _as_if_on_the_card

from repro.models import layers as jlayers
from repro.models import losses as jlosses
from repro.models import mamba2 as jmamba2
from repro_torch.kernels import flash_attention, rmsnorm
from repro_torch.models import layers, losses, mamba2

FROM_TRUTH = 1.25      # the port's distance from the truth over JAX's
TO_JAX = 1e-4          # the layers that compute as JAX does
BF16, FP32 = "bfloat16", "float32"


def _draws(seed: int, *shapes, scale: float = 1.0) -> list:
    """Normal draws of ``shapes``, rounded to bf16 once, as fp32 numpy."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((scale * rng.standard_normal(s)).astype(
        np.float32)).bfloat16().float().numpy() for s in shapes]


# ------------------------------------------------------------- the cases --
# each case's function returns (port_fn, jax_fn, arrays, dtypes,
# holds_to_jax, route): the two layers take the float inputs alone; route
# "functions" runs the port as if on the card
def _attention(mode: str, group: int, causal=True, window=None,
               route="plain"):
    def build():
        # each of dk and dv holds 65536 values: one value rounded to the
        # other side of a bf16 tie moves the distance by well under 1e-4
        b, hkv, s, d, chunk = 4, 2, 128, 64, 32
        dense_max = 1024 if mode == "dense" else chunk
        kw = dict(causal=causal, window=window, dense_max_seq=dense_max,
                  chunk=chunk, block_skip=mode == "skip")
        pos = jnp.arange(s)
        arrays = _draws(group * 10 + s, (b, hkv * group, s, d),
                        (b, hkv, s, d), (b, hkv, s, d))
        return (lambda q, k, v: layers.attention(q, k, v, **kw),
                lambda q, k, v: jlayers.attention(q, k, v, q_pos=pos,
                                                  k_pos=pos, **kw),
                arrays, (BF16,) * 3, True, route)
    return build


def _rmsnorm(route: str):
    def build():
        x, w = _draws(1, (4, 6, 64), (64,))
        return (lambda x, w: layers.rmsnorm(x, w, 1e-5),
                lambda x, w: jlayers.rmsnorm(x, w, 1e-5),
                [x, w + 1.0], (BF16, FP32), True, route)
    return build


def _rope():
    pos = np.arange(3, 19)
    (x,) = _draws(2, (2, 16, 4, 32))
    return (lambda x: layers.apply_rope(x, torch.from_numpy(pos), 10000.0),
            lambda x: jlayers.apply_rope(x, jnp.asarray(pos), 10000.0),
            [x], (BF16,), True, "plain")


def _swiglu():
    x, w1, w3, w2 = _draws(3, (2, 8, 64), (64, 96), (64, 96), (96, 64),
                           scale=0.3)
    return (lambda *a: layers.swiglu(*a), lambda *a: jlayers.swiglu(*a),
            [x * 3.0, w1, w3, w2], (BF16,) * 4, False, "plain")


def _moe():
    b, s, m, e, f, k = 2, 16, 64, 4, 96, 2
    x, router, w1, w3, w2 = _draws(4, (b, s, m), (m, e), (e, m, f),
                                   (e, m, f), (e, f, m), scale=0.2)
    kw = dict(n_experts=e, top_k=k, capacity=12)
    return (lambda *a: layers.moe_ffn(*a, **kw),
            lambda *a: jlayers.moe_ffn(*a, **kw),
            [x * 5.0, router, w1, w3, w2], (BF16,) + (FP32,) * 4, False,
            "plain")


def _loss(onehot: bool):
    def build():
        (logits,) = _draws(5, (2, 12, 80), scale=3.0)
        t = np.random.default_rng(6).integers(0, 80, (2, 12))
        return (lambda lg: losses.lm_cross_entropy(
                    lg, torch.from_numpy(t), onehot=onehot),
                lambda lg: jlosses.lm_cross_entropy(
                    lg, jnp.asarray(t, jnp.int32), onehot=onehot),
                [logits], (BF16,), True, "plain")
    return build


def _ssd():
    b, L, h, p, n = 2, 40, 3, 8, 8
    rng = np.random.default_rng(7)
    x, bb, cc = _draws(8, (b, L, h, p), (b, L, n), (b, L, n))
    dt = np.log1p(np.exp(rng.standard_normal((b, L, h)) - 2)).astype(
        np.float32)
    a_log = np.log(rng.uniform(1, 16, h)).astype(np.float32)
    d_skip = (1 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    return (lambda x, dt, a, b_, c, d: mamba2.ssd_chunked(x, dt, a, b_, c, d,
                                                          chunk=16),
            lambda x, dt, a, b_, c, d: jmamba2.ssd_chunked(x, dt, a, b_, c,
                                                           d, chunk=16),
            [x, dt, a_log, bb, cc, d_skip],
            (BF16, FP32, FP32, BF16, BF16, FP32), False, "plain")


def _jax_causal_conv(xbc, w, bias):
    """The reference's depthwise causal conv (mamba2.py:184-189)."""
    S = xbc.shape[1]
    w = w.astype(xbc.dtype)
    K = w.shape[0]
    pad = jnp.pad(xbc, ((0, 0), (K - 1, 0), (0, 0)))
    conv = sum(pad[:, i:i + S] * w[i][None, None] for i in range(K))
    return jax.nn.silu(conv + bias.astype(conv.dtype))


def _conv():
    xbc, w, bias = _draws(9, (2, 24, 48), (4, 48), (48,), scale=0.5)
    return (mamba2.causal_conv, _jax_causal_conv, [xbc * 2.0, w, bias],
            (BF16, FP32, FP32), False, "plain")


CASES = {
    "attention-dense-causal-g1": _attention("dense", 1),
    "attention-dense-causal-g2": _attention("dense", 2),
    "attention-dense-causal-g4": _attention("dense", 4),
    "attention-dense-window-g2": _attention("dense", 2, window=40),
    "attention-dense-full-g4": _attention("dense", 4, causal=False),
    "attention-chunked-causal-g1": _attention("chunked", 1),
    "attention-chunked-causal-g2": _attention("chunked", 2),
    "attention-chunked-full-g4": _attention("chunked", 4, causal=False),
    "attention-skip-causal-g4": _attention("skip", 4),
    "attention-skip-window-g2": _attention("skip", 2, window=40),
    "attention-function-dense-g4": _attention("dense", 4,
                                              route="functions"),
    "attention-function-chunked-g2": _attention("chunked", 2, window=40,
                                                route="functions"),
    "attention-function-skip-g4": _attention("skip", 4, route="functions"),
    "rmsnorm": _rmsnorm("plain"),
    "rmsnorm-function": _rmsnorm("functions"),
    "apply_rope": _rope,
    "swiglu": _swiglu,
    "moe_ffn": _moe,
    "lm_cross_entropy-gather": _loss(False),
    "lm_cross_entropy-onehot": _loss(True),
    "ssd_chunked": _ssd,
    "causal_conv": _conv,
}


# ------------------------------------------------------------ the grads --
def _cotangents(outs, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(tuple(o.shape)).astype(np.float32)
            for o in outs]


def _port_grads(fn, arrays, dtypes) -> list:
    ins = [torch.from_numpy(a).to(getattr(torch, dt)).requires_grad_()
           for a, dt in zip(arrays, dtypes)]
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    cts = _cotangents(outs, 99)
    sum((o.float() * torch.from_numpy(c)).sum()
        for o, c in zip(outs, cts)).backward()
    for t, dt in zip(ins, dtypes):
        assert t.grad.dtype == getattr(torch, dt)
    return [t.grad.double().numpy() for t in ins]


def _jax_grads(fn, arrays, dtypes) -> list:
    ins = [jnp.asarray(a, getattr(jnp, dt)) for a, dt in zip(arrays, dtypes)]

    def loss(*a):
        outs = fn(*a)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return sum(jnp.sum(o.astype(jnp.float32) * c)
                   for o, c in zip(outs, _cotangents(outs, 99)))

    grads = jax.grad(loss, argnums=tuple(range(len(ins))))(*ins)
    return [np.asarray(g.astype(jnp.float32), np.float64) for g in grads]


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _grads_of(case: str, monkeypatch) -> tuple:
    """(the port's grads, JAX's, the truth's, whether the layer holds to
    JAX) of ``case``; a "functions" route runs with its launches replaced
    by their plain versions and counted (at least one)."""
    port_fn, jax_fn, arrays, dtypes, holds_to_jax, route = CASES[case]()
    launched = []
    if route == "functions":
        def counted(fn):
            def run(*args, **kw):
                launched.append(fn)
                return fn(*args, **kw)
            return run

        monkeypatch.setattr(rmsnorm, "rmsnorm", counted(rmsnorm.plain))
        monkeypatch.setattr(flash_attention, "launch",
                            counted(flash_attention.plain))
        _as_if_on_the_card(monkeypatch)
    port = _port_grads(port_fn, arrays, dtypes)
    assert bool(launched) == (route == "functions")
    want = _jax_grads(jax_fn, arrays, dtypes)
    truth = _jax_grads(jax_fn, arrays, (FP32,) * len(arrays))
    return port, want, truth, holds_to_jax


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_grads_are_no_further_from_the_truth_than_jax(case,
                                                           monkeypatch):
    port, want, truth, holds_to_jax = _grads_of(case, monkeypatch)
    for i, (p, j, t) in enumerate(zip(port, want, truth)):
        assert p.shape == t.shape and np.linalg.norm(t) > 0, i
        from_truth, jax_from_truth = _rel(p, t), _rel(j, t)
        assert from_truth <= FROM_TRUTH * jax_from_truth, \
            (i, from_truth, jax_from_truth)
        if holds_to_jax:
            assert _rel(p, j) <= TO_JAX, (i, _rel(p, j))


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=src:tests python
    # tests/test_torch_bf16_grads.py: each case's distances, a grad each,
    # as [the port's from JAX's, the port's from the truth, JAX's from
    # the truth]
    for name in sorted(CASES):
        with pytest.MonkeyPatch.context() as patch:
            got = _grads_of(name, patch)[:3]
        print(name, " ".join(f"[{_rel(p, j):.2e} {_rel(p, t):.2e} "
                             f"{_rel(j, t):.2e}]" for p, j, t in zip(*got)))
