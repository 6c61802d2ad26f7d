"""The port's long-sequence attention (``models.layers.attention`` with
``dense_max_seq``, ``chunk`` and ``block_skip``) against the JAX layer's,
on the CPU.

The same numpy draws go through ``repro.models.layers.attention`` (with
``jax.vjp`` for the grads) and the port's layer, whose flash attention
takes its plain versions here: ``flash_attention.plain`` on the dense path,
``plain_chunked`` above ``dense_max_seq``.  B=2, Hq=4, Hkv=2, D=16, chunk 32
and ``dense_max_seq`` 32: at S=128 the chunked and block-skip paths, causal,
with a window of 40 (not a multiple of the chunk) or 32, and not causal; at
S=120, which the chunk does not divide, the dense fallback.  Tolerances:
values and grads within 2e-5 absolute and relative in fp32 (sums in
another order); bf16 outputs within one bf16 ulp of the fp32 result (both
compute in fp32 and round once).  The chunk-wise backward
(``plain_backward``) is held to autograd through the dense ``plain``
within 2e-5, and on meta tensors at llama3.2-1b's heads over 4096 tokens
no op of the chunked forward or backward outputs more than a chunk's
(B, Hq, chunk, Sk) scores, where the dense ``plain`` makes (B, Hq, S, S).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro.models import layers as jlayers
from repro_torch.kernels import flash_attention, ops
from repro_torch.models import layers

B, HQ, HKV, D, CHUNK = 2, 4, 2, 16, 32
FP32 = dict(rtol=2e-5, atol=2e-5)
# (S, causal, window, block_skip)
CASES = [(128, causal, window, skip)
         for causal, window in ((True, None), (True, 40), (True, 32),
                                (False, None))
         for skip in (False, True)]
CASES += [(120, True, None, True), (120, True, 40, False)]


def _ids(case):
    s, causal, window, skip = case
    return (f"S{s}-{'causal' if causal else 'full'}-w{window}"
            f"{'-skip' if skip else ''}")


def _draws(s: int, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, HQ, s, D), (B, HKV, s, D), (B, HKV, s, D),
                          (B, HQ, s, D))]


def _jax(s, causal, window, skip):
    pos = jnp.arange(s)
    return lambda q, k, v: jlayers.attention(
        q, k, v, q_pos=pos, k_pos=pos, causal=causal, window=window,
        dense_max_seq=CHUNK, chunk=CHUNK, block_skip=skip)


def _port(causal, window, skip):
    return lambda q, k, v: layers.attention(
        q, k, v, causal=causal, window=window, dense_max_seq=CHUNK,
        chunk=CHUNK, block_skip=skip)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_values_and_grads_match_jax(case):
    s, causal, window, skip = case
    qa, ka, va, ga = _draws(s, seed=s + 7 * (window or 0) + causal + skip)
    out, vjp = jax.vjp(_jax(s, causal, window, skip),
                       *map(jnp.asarray, (qa, ka, va)))
    want = (out, *vjp(jnp.asarray(ga)))
    qkv = [torch.from_numpy(a).requires_grad_() for a in (qa, ka, va)]
    got = _port(causal, window, skip)(*qkv)
    got = (got, *torch.autograd.grad(got, qkv, torch.from_numpy(ga)))
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(_np(g), _np(w), **FP32, err_msg=name)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at the magnitude of each of ``x`` (7 stored bits)."""
    _, exp = np.frexp(np.abs(x))
    return np.ldexp(1.0, exp - 8)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_bf16_values_are_within_an_ulp_of_jax(case):
    s, causal, window, skip = case
    qa, ka, va, _ = _draws(s, seed=11 + s)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (qa, ka, va))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (qa, ka, va))
    fn = _jax(s, causal, window, skip)
    want = fn(jq, jk, jv)
    assert want.dtype == jnp.bfloat16
    exact = _np(fn(*(x.astype(jnp.float32) for x in (jq, jk, jv))))
    got = _port(causal, window, skip)(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    err = np.abs(_np(got) - _np(want))
    assert (err <= _bf16_ulp(exact)).all(), err.max()


@pytest.mark.parametrize("causal,window", [(True, None), (True, 40),
                                           (True, 32), (False, None)])
@pytest.mark.parametrize("skip", [False, True], ids=["chunked", "skip"])
def test_chunk_wise_backward_equals_the_dense_one(causal, window, skip):
    qa, ka, va, ga = _draws(128, seed=5)
    q, k, v, g = map(torch.from_numpy, (qa, ka, va, ga))
    kw = dict(causal=causal, window=window)
    got = flash_attention.plain_backward(q, k, v, g, **kw, chunk=CHUNK,
                                         block_skip=skip)
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention.plain(*qkv, **kw), qkv, g)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(_np(a), _np(b), **FP32, err_msg=name)
    out = flash_attention.plain_chunked(q, k, v, **kw, chunk=CHUNK,
                                        block_skip=skip)
    np.testing.assert_allclose(_np(out), _np(flash_attention.plain(q, k, v,
                                                                   **kw)),
                               **FP32)


class _Largest(TorchDispatchMode):
    """The most elements any op's output has while open."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.numel = max(self.numel, t.numel())
        return out


@pytest.mark.parametrize("skip", [False, True], ids=["chunked", "skip"])
def test_the_functions_backward_runs_by_chunks(skip, monkeypatch):
    """``FlashAttentionFunction`` (its launch replaced by the plain
    version: the kernel runs only on the card) takes ``plain_backward``
    where it is given a chunk, and the dense backward where not: the
    grads agree, and the chunk-wise one made no (S, S) tensor."""
    monkeypatch.setattr(flash_attention, "launch",
                        lambda q, k, v, **kw: flash_attention.plain(q, k, v,
                                                                    **kw))
    qa, ka, va, ga = _draws(128, seed=9)
    grads = {}
    for chunk in (None, CHUNK):
        qkv = [torch.from_numpy(a).requires_grad_() for a in (qa, ka, va)]
        out = flash_attention.FlashAttentionFunction.apply(
            *qkv, True, 40, None, chunk, skip)
        with _Largest() as largest:
            grads[chunk] = torch.autograd.grad(out, qkv,
                                               torch.from_numpy(ga))
        grads[chunk] += (largest.numel,)
    for a, b in zip(grads[None][:3], grads[CHUNK][:3]):
        np.testing.assert_allclose(_np(a), _np(b), **FP32)
    assert grads[None][3] == B * HQ * 128 * 128
    assert grads[CHUNK][3] <= B * HQ * CHUNK * 128


def test_ops_refuses_a_chunk_that_does_not_divide_the_sequence():
    q = torch.zeros(1, 2, 48, D)
    kv = torch.zeros(1, 1, 48, D)
    for force in (None, "ref"):
        with pytest.raises(ValueError, match="not divisible by attn chunk"):
            ops.flash_attention(q, kv, kv, bq=48, bk=48, chunk=32,
                                force=force)


# llama3.2-1b's heads over train_4k's 2 x 4096 tokens, the reference's chunk
META = dict(b=2, hq=32, hkv=8, s=4096, d=64, chunk=1024)


def _meta():
    m = META
    q = torch.empty(m["b"], m["hq"], m["s"], m["d"], device="meta",
                    dtype=torch.bfloat16)
    kv = torch.empty(m["b"], m["hkv"], m["s"], m["d"], device="meta",
                     dtype=torch.bfloat16)
    return q, kv, torch.empty_like(q)


@pytest.mark.parametrize("skip", [False, True], ids=["chunked", "skip"])
def test_no_op_of_the_chunked_path_makes_the_score_tensor(skip):
    """Fault D's repair: a chunk's (B, Hq, chunk, Sk) fp32 scores are the
    largest output of any op of ``plain_chunked`` and of
    ``plain_backward``, not the (B, Hq, S, S) of the dense version."""
    q, kv, g = _meta()
    m = META
    kw = dict(causal=True, window=None, chunk=m["chunk"], block_skip=skip)
    with _Largest() as fwd:
        out = flash_attention.plain_chunked(q, kv, kv, **kw)
    with _Largest() as bwd:
        grads = flash_attention.plain_backward(q, kv, kv, g, **kw)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert [t.shape for t in grads] == [q.shape, kv.shape, kv.shape]
    assert max(fwd.numel, bwd.numel) == m["b"] * m["hq"] * m["chunk"] * m["s"]


def test_the_dense_plain_makes_the_score_tensor():
    """Fault D as it was: the dense ``plain``, which the port ran at every
    length, makes (B, Hq, S, S) outputs, S / chunk times the chunked
    path's largest."""
    q, kv, _ = _meta()
    with _Largest() as dense:
        flash_attention.plain(q, kv, kv, causal=True)
    assert dense.numel == META["b"] * META["hq"] * META["s"] ** 2
