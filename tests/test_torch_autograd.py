"""The backward of the port's kernels, on the CPU.

``matmul``, ``rmsnorm`` and ``flash_attention`` launch through an
``autograd.Function`` where a graph is recorded: the kernel forward, a plain
PyTorch backward.  Here each launch is monkeypatched to its plain version
(there is no card), and each Function's backward is held to

* ``torch.autograd.gradcheck`` in float64;
* ``jax.grad`` of ``repro.kernels.ref``'s function on the same numpy inputs
  and cotangent: fp32 at rtol = atol = 2e-5 for rmsnorm (summation order,
  rsqrt) and 1e-5 for matmul and attention, bf16 at 2e-2 (one bf16
  rounding of each gradient);

and the port's ``DecoderLM.loss`` grads, through the Functions and through
the plain versions, to the JAX decoder's ``value_and_grad(model.loss)`` on
JAX's weights, for the 2-layer smoke llama3.2-1b (d_model 64, fp32
parameters), both recomputing each layer in the backward (remat, the
configs' default).  With fp32 activations at rtol 1e-4, atol 1e-5; in the
models' own bf16 activations at a relative Frobenius error of 3e-2 a
parameter, the bound the card is held to against the CPU
(tests/test_torch_cuda.py): there bf16 roundings in another order flip
single values by an ulp, about 0.5% of each grad's norm at this size.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as jax_transformer
from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels import ref as jref
from repro.models import get_model as jax_get_model
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import flash_attention, matmul, ops, rmsnorm
from repro_torch.models import get_model
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_numpy

TOL = {("rmsnorm", "float32"): 2e-5, ("matmul", "float32"): 1e-5,
       ("attention", "float32"): 1e-5}
BF16_TOL = 2e-2


def _arrays(seed: int, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _torch(a: np.ndarray, dtype: str) -> torch.Tensor:
    """``a`` in ``dtype``, a leaf that requires grad."""
    return torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_()


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture
def launches(monkeypatch) -> collections.Counter:
    """Each kernel's launch replaced by its plain version, counted."""
    calls = collections.Counter()

    def counted(name, fn):
        def run(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return run

    monkeypatch.setattr(rmsnorm, "rmsnorm", counted("rmsnorm",
                                                    rmsnorm.plain))
    monkeypatch.setattr(flash_attention, "launch",
                        counted("flash_attention", flash_attention.plain))
    monkeypatch.setattr(matmul, "matmul", counted("matmul", matmul.plain))
    return calls


# ------------------------------------------------------------- gradcheck --
@pytest.mark.parametrize("rows,d,eps", [(5, 8, 1e-5), (1, 16, 1e-6),
                                        (3, 4, 1e-2)])
def test_rmsnorm_backward_passes_gradcheck(launches, rows, d, eps):
    xa, wa = _arrays(1, (rows, d), (d,))
    x, w = _torch(xa, "float64"), _torch(wa + 1.0, "float64")
    assert torch.autograd.gradcheck(
        lambda x, w: rmsnorm.RMSNormFunction.apply(x, w, eps), (x, w))
    assert launches["rmsnorm"] > 0


@pytest.mark.parametrize("m,k,n", [(3, 5, 4), (1, 7, 2), (6, 1, 3)])
def test_matmul_backward_passes_gradcheck(launches, m, k, n):
    x, y = (_torch(a, "float64") for a in _arrays(2, (m, k), (k, n)))
    assert torch.autograd.gradcheck(
        lambda x, y: matmul.MatmulFunction.apply(x, y, None), (x, y))
    assert launches["matmul"] > 0


# (B, Hq, Hkv, S, Sk, D), causal, window, sm_scale: GQA and MHA, no mask,
# a window, S > Sk with rows that see no key, an explicit scale
ATTN_CASES = {
    "causal-gqa": ((1, 4, 2, 6, 6, 8), True, None, None),
    "full-mha": ((2, 2, 2, 5, 5, 4), False, None, None),
    "window": ((1, 2, 1, 7, 7, 4), True, 3, None),
    "keyless-rows": ((1, 2, 1, 8, 4, 4), True, 2, None),
    "scale": ((1, 3, 1, 4, 4, 4), True, None, 0.7),
}


def _qkv(shape, dtype: str, seed: int):
    b, hq, hkv, s, sk, d = shape
    return [_torch(a, dtype) for a in _arrays(
        seed, (b, hq, s, d), (b, hkv, sk, d), (b, hkv, sk, d))]


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_attention_backward_passes_gradcheck(launches, case):
    shape, causal, window, scale = ATTN_CASES[case]
    q, k, v = _qkv(shape, "float64", 3)
    assert torch.autograd.gradcheck(
        lambda q, k, v: flash_attention.FlashAttentionFunction.apply(
            q, k, v, causal, window, scale), (q, k, v))
    assert launches["flash_attention"] > 0


def test_rows_that_see_no_key_pass_back_no_gradient(launches):
    shape, causal, window, scale = ATTN_CASES["keyless-rows"]
    q, k, v = _qkv(shape, "float64", 4)
    out = flash_attention.FlashAttentionFunction.apply(q, k, v, causal,
                                                       window, scale)
    out.sum().backward()
    # rows 5-7 see keys 4-6 and up, past Sk = 4: none
    assert not bool(out[:, :, 5:].any())
    assert not bool(q.grad[:, :, 5:].any())
    assert bool(q.grad[:, :, :5].any())


# --------------------------------------------------------- against JAX --
def _vjp_pair(port_fn, jax_fn, arrays, dtypes, ct_seed):
    """Gradients of sum(f(inputs) * ct) from both sides: the port's
    Function on torch tensors, ``jax.grad`` on jax arrays, the same numpy
    values in the same dtypes."""
    ins = [_torch(a, dt) for a, dt in zip(arrays, dtypes)]
    out = port_fn(*ins)
    ct = np.random.default_rng(ct_seed).standard_normal(
        out.shape).astype(np.float32)
    (out.float() * torch.from_numpy(ct)).sum().backward()
    jins = [jnp.asarray(a, getattr(jnp, dt)) for a, dt in zip(arrays, dtypes)]
    jgrads = jax.grad(lambda *a: jnp.sum(jax_fn(*a).astype(jnp.float32) * ct),
                      argnums=tuple(range(len(jins))))(*jins)
    return [(t.grad, g) for t, g in zip(ins, jgrads)]


def _close(pairs, tol):
    for got, want in pairs:
        assert got.dtype == getattr(torch, str(want.dtype))
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("x_dtype,w_dtype", [("float32", "float32"),
                                             ("bfloat16", "bfloat16"),
                                             ("bfloat16", "float32")])
@pytest.mark.parametrize("rows,d", [(8, 64), (3, 2048)])
def test_rmsnorm_backward_matches_jax_grad(launches, rows, d, x_dtype,
                                           w_dtype):
    x, w = _arrays(5, (rows, d), (d,))
    w += 1.0
    pairs = _vjp_pair(
        lambda x, w: rmsnorm.RMSNormFunction.apply(x, w, 1e-5),
        lambda x, w: jref.rmsnorm(x, w, 1e-5), (x, w), (x_dtype, w_dtype), 6)
    _close(pairs, TOL.get(("rmsnorm", x_dtype), BF16_TOL))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(16, 32, 24), (1, 64, 8)])
def test_matmul_backward_matches_jax_grad(launches, m, k, n, dtype):
    pairs = _vjp_pair(lambda x, y: matmul.MatmulFunction.apply(x, y, None),
                      jref.matmul, _arrays(7, (m, k), (k, n)),
                      (dtype, dtype), 8)
    _close(pairs, TOL.get(("matmul", dtype), BF16_TOL))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_attention_backward_matches_jax_grad(launches, case, dtype):
    (b, hq, hkv, s, sk, d), causal, window, scale = ATTN_CASES[case]
    kw = dict(causal=causal, window=window, sm_scale=scale)
    pairs = _vjp_pair(
        lambda q, k, v: flash_attention.FlashAttentionFunction.apply(
            q, k, v, causal, window, scale),
        lambda q, k, v: jref.attention(q, k, v, **kw),
        _arrays(9, (b, hq, s, d), (b, hkv, sk, d), (b, hkv, sk, d)),
        (dtype,) * 3, 10)
    _close(pairs, TOL.get(("attention", dtype), BF16_TOL))


# ------------------------------------------------------------ the route --
def _as_if_on_the_card(monkeypatch):
    """``ops`` takes the kernel route for CPU tensors (each launch is
    already its plain version, by the ``launches`` fixture)."""
    monkeypatch.setattr(ops, "_use_kernel", lambda x, force: force != "ref")


def test_ops_take_the_functions_only_where_a_graph_is_recorded(
        launches, monkeypatch):
    _as_if_on_the_card(monkeypatch)
    x, w = _arrays(11, (4, 16), (16,))
    q, k, v = _arrays(12, (1, 2, 4, 8), (1, 1, 4, 8), (1, 1, 4, 8))
    calls = {
        "rmsnorm": lambda t: ops.rmsnorm(t[0], t[1], block_rows=4),
        "flash_attention": lambda t: ops.flash_attention(*t, bq=4, bk=4),
        "matmul": lambda t: ops.matmul(t[0], t[1].T.contiguous(), bm=4,
                                       bn=4, bk=16)}
    inputs = {"rmsnorm": (x, w), "flash_attention": (q, k, v),
              "matmul": (x, x)}
    for name, call in calls.items():
        node = {"rmsnorm": "RMSNormFunction",
                "flash_attention": "FlashAttentionFunction",
                "matmul": "MatmulFunction"}[name]
        grad = [torch.from_numpy(a).requires_grad_() for a in inputs[name]]
        out = call(grad)
        assert type(out.grad_fn).__name__ == f"{node}Backward"
        bare = [torch.from_numpy(a) for a in inputs[name]]
        assert call(bare).grad_fn is None
        with torch.inference_mode():
            out = call(grad)
        assert out.grad_fn is None and torch.is_inference(out)
        with torch.no_grad():
            assert call(grad).grad_fn is None
        # one launch a forward, and none in the backward
        before = launches[name]
        out = call(grad)
        out.float().sum().backward()
        assert launches[name] == before + 1


# ---------------------------------------------------------- the decoder --
class _Float32Jnp:
    """``jax.numpy`` with ``bfloat16`` read as float32: the JAX decoder casts
    its embeddings with the literal ``jnp.bfloat16``
    (src/repro/models/transformer.py:144), so swapping its module's ``jnp``
    for this one runs it in fp32 activations without touching its code."""

    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.mark.parametrize("activations", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["functions", "plain"])
def test_decoder_loss_grads_match_jax(launches, monkeypatch, route,
                                      activations):
    if activations == "float32":
        monkeypatch.setattr(jax_transformer, "jnp", _Float32Jnp())
        monkeypatch.setattr(transformer, "ACT_DTYPE", torch.float32)
    if route == "functions":
        _as_if_on_the_card(monkeypatch)
    jcfg = jax_smoke_config("llama3.2-1b")
    tcfg = get_smoke_config("llama3.2-1b")
    assert (tcfg.n_layers, tcfg.d_model) == (2, 64)
    jm, tm = jax_get_model(jcfg), get_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    for p in tp.values():
        assert p.dtype == torch.float32
        p.requires_grad_()
    rng = np.random.default_rng(13)
    toks, tgts = (rng.integers(0, tcfg.vocab_size, (2, 17)) for _ in "tt")
    (jl, _), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {"tokens": jnp.asarray(toks, jnp.int32),
             "targets": jnp.asarray(tgts, jnp.int32)})
    tl, _ = tm.loss(tp, {"tokens": torch.from_numpy(toks),
                         "targets": torch.from_numpy(tgts)})
    tl.backward()
    layers = tcfg.n_layers
    # the forward's 2L + 1 norms and L attentions, and the backward's
    # recompute of each layer (remat, the config's default): 2L and L more
    assert tcfg.remat
    assert dict(launches) == ({"rmsnorm": 4 * layers + 1,
                               "flash_attention": 2 * layers}
                              if route == "functions" else {})
    assert set(tp) == set(jg)
    for name, p in tp.items():
        got, want = _np(p.grad), _np(jg[name])
        assert got.shape == want.shape and np.abs(got).max() > 0, name
        if activations == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                       err_msg=name)
        else:
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel <= 3e-2, (name, rel)
    np.testing.assert_allclose(tl.item(), float(jl),
                               rtol=1e-4 if activations == "float32"
                               else 3e-2)
