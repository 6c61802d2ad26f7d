"""Recomputation (remat) in the port's training forwards, on the CPU.

The JAX package checkpoints each layer of a training forward
(``jax.checkpoint``; ``remat=True`` and ``remat_policy="nothing"`` are the
config's defaults): ``DecoderLM``'s layers under the config's policy,
mamba2's and hymba's under ``nothing_saveable`` whatever it says, and each
chunk of the sequence-chunked cross-entropy.  The port runs the same
regions under ``models.layers.remat``.  On the smoke llama3.2-1b, mixtral,
mamba2-780m, hymba-1.5b and hubert-xlarge, in fp32 activations:

* remat changes no bit: the loss and every grad of ``loss_and_grads`` with
  remat on equal remat off (``torch.equal``), under ``"nothing"``, under
  ``"dots"`` on the decoders and with ``logits_chunk=4``;
* with remat on, the loss and grads against JAX's jitted
  ``value_and_grad`` with remat on, on JAX's weights, at
  test_torch_families.py's fp32 bounds (rtol 1e-4, atol 1e-5);
* the backward recomputes what each policy says, counted in ``aten.mm``
  calls and in calls of the plain norm and attention (the CPU's versions
  of the kernels): ``"nothing"`` every product of a layer again but its
  last, whose output no backward reads (torch's early stop; XLA drops the
  same product from the reference's recompute as dead code), and every
  norm and attention; ``"dots"`` no product without batch dims and every
  norm and attention; mamba2 and hymba ``"nothing"`` under either policy;
  and the smoke llama3.2-1b's recompute runs as many products as JAX's
  compiled ``value_and_grad`` holds more dots with remat;
* the serving steps (prefill, decode, encode) make the same calls with
  remat on and off, and never enter a checkpoint.
"""
import collections
import contextlib
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.models.hybrid as jax_hybrid
import repro.models.mamba2 as jax_mamba2
import repro.models.transformer as jax_transformer
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import get_model as jax_get_model
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import flash_attention, rmsnorm
from repro_torch.models import (get_model, hybrid, layers, loss_and_grads,
                                make_decode_step, make_encode_step,
                                make_prefill_step, mamba2, transformer)
from repro_torch.models.convert import params_from_numpy
from repro_torch.parallel.sharding import current_ctx, use_sharding
from test_torch_autograd import _Float32Jnp

LLAMA, MIXTRAL, MAMBA2, HYMBA, HUBERT = (
    "llama3.2-1b", "mixtral-8x22b", "mamba2-780m", "hymba-1.5b",
    "hubert-xlarge")
ARCHS = (LLAMA, MIXTRAL, MAMBA2, HYMBA, HUBERT)
DECODERS = (LLAMA, MIXTRAL, HUBERT)   # DecoderLM: the policy applies
# remat on against remat off: (arch, config changes of both runs, of the
# remat run)
VARIANTS = {f"{a}-nothing": (a, {}, {}) for a in ARCHS}
VARIANTS.update({f"{a}-dots": (a, {}, {"remat_policy": "dots"})
                 for a in DECODERS})
VARIANTS.update({f"{a}-chunk4": (a, {"logits_chunk": 4}, {})
                 for a in (LLAMA, HUBERT)})
FP32 = dict(rtol=1e-4, atol=1e-5)
POLICIES = ("nothing", "dots")
SEQ = 40   # past hymba-smoke's window of 32, across mamba2-smoke's chunks


@pytest.fixture
def fp32(monkeypatch):
    """Both packages in fp32 activations: the JAX modules read
    ``jnp.bfloat16`` as float32, the port's ACT_DTYPE is float32."""
    for mod in (jax_mamba2, jax_hybrid, jax_transformer):
        monkeypatch.setattr(mod, "jnp", _Float32Jnp())
    for mod in (mamba2, hybrid, transformer):
        monkeypatch.setattr(mod, "ACT_DTYPE", torch.float32)


def _batch(cfg, seed: int = 13) -> dict:
    """Numpy inputs from a seed: tokens (frames for the encoder) and
    targets, (2, SEQ)."""
    rng = np.random.default_rng(seed)
    batch = {"targets": rng.integers(0, cfg.vocab_size, (2, SEQ))}
    if cfg.frontend == "frames":
        batch["frames"] = rng.standard_normal(
            (2, SEQ, cfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (2, SEQ))
    return batch


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _params(cfg, seed: int = 0) -> dict:
    return get_model(cfg).init(torch.Generator().manual_seed(seed))


# ------------------------------------------------------- the helper itself
def test_remat_calls_fn_bare_where_autograd_does_not_record(monkeypatch):
    """Only where autograd records does ``remat`` checkpoint: with grad mode
    off, under ``inference_mode`` or with no input that requires grad it
    calls the function as it is."""
    entered = []

    def counting(fn, *args, **kw):
        entered.append(kw)
        return torch.utils.checkpoint.checkpoint(fn, *args, **kw)

    monkeypatch.setattr(layers, "checkpoint", counting)
    x, w = torch.randn(3, 4), torch.randn(4, 4)
    for policy in POLICIES:
        fn = layers.remat(lambda x, p: x @ p["w"], policy)
        want = x @ w
        assert torch.equal(fn(x, {"w": w}), want)
        with torch.no_grad():
            assert torch.equal(fn(x, {"w": w.requires_grad_()}), want)
        with torch.inference_mode():
            assert torch.equal(fn(x, {"w": w}), want)
        assert entered == []
        out = fn(x, {"w": w.requires_grad_()})
        out.sum().backward()
        assert torch.equal(out.detach(), want)
        assert len(entered) == 1 and entered.pop()["use_reentrant"] is False
        w = w.detach()


def test_the_recompute_runs_in_the_forwards_sharding_context():
    """The backward of CUDA tensors runs on autograd's device thread, where
    the caller's sharding context is unset; the recompute takes the
    forward's.  Here the backward runs on a thread of its own."""
    seen = []

    def fn(x):
        seen.append(current_ctx())
        return (x * 2).sin()

    x = torch.randn(4, requires_grad=True)
    for policy in POLICIES:
        seen.clear()
        with use_sharding(None) as ctx:
            y = layers.remat(fn, policy)(x).sum()
        grads = []
        t = threading.Thread(target=lambda: grads.extend(
            torch.autograd.grad(y, x)))
        t.start()
        t.join()
        assert current_ctx() is None
        assert seen == [ctx, ctx] and ctx is not None
        assert torch.equal(grads[0], 2 * torch.cos(2 * x.detach()))


def _backward_calls(fn, *args) -> collections.Counter:
    """The aten ops that the backward of ``fn(*args).sum()`` runs."""
    out = fn(*args).sum()
    with _Ops() as ops:
        torch.autograd.grad(out, [a for a in args if a.requires_grad])
    return ops.calls


def test_a_policy_but_dots_keeps_nothing_as_the_references_does():
    """The reference maps every ``remat_policy`` but ``"dots"`` to
    ``nothing_saveable`` (transformer.py:27-30); so does ``remat``."""
    x = torch.randn(3, 4, requires_grad=True)
    w = torch.randn(4, 4, requires_grad=True)

    def fn(x, w):
        return (x @ w).sin() @ w

    calls = {p: _backward_calls(layers.remat(fn, p), x, w)
             for p in ("nothing", "everything", "dots")}
    mm = torch.ops.aten.mm.default
    assert calls["everything"] == calls["nothing"]
    assert calls["nothing"][mm] == calls["dots"][mm] + 1


def test_dots_keeps_an_einsum_by_its_dims_not_by_its_batch_size():
    """An einsum lowers to ``bmm`` over a batch of 1 whether it has batch
    dims or not.  ``"dots"`` keeps the one without (marked as the MoE
    router's is) and recomputes one with a batch dim of size 1."""
    bmm = torch.ops.aten.bmm.default
    x = torch.randn(1, 3, 4, requires_grad=True)
    w = torch.randn(4, 4, requires_grad=True)

    def unbatched(x, w):
        with layers._no_batch_dims():
            return torch.einsum("bsm,me->bse", x, w).sin()

    def batched(x, w):
        return torch.einsum("bsm,bme->bse", x, w[None]).sin()

    for fn, again in ((unbatched, 0), (batched, 1)):
        plain = _backward_calls(fn, x, w)[bmm]
        assert _backward_calls(layers.remat(fn, "dots"), x, w)[bmm] \
            == plain + again
        assert _backward_calls(layers.remat(fn, "nothing"), x, w)[bmm] \
            == plain + 1


# ------------------------------------------------------------ no bit moved
@pytest.mark.parametrize("case", sorted(VARIANTS))
def test_remat_changes_no_bit_of_the_loss_and_grads(fp32, case):
    arch, both, on = VARIANTS[case]
    cfg = dataclasses.replace(get_smoke_config(arch), **both)
    params = _params(cfg)
    batch = _torch_batch(_batch(cfg))
    grads, losses = {}, {}
    for remat in (False, True):
        model = get_model(dataclasses.replace(cfg, remat=remat,
                                              **(on if remat else {})))
        grads[remat], metrics = loss_and_grads(model, params, batch)
        losses[remat] = metrics["loss"]
    assert torch.equal(losses[True], losses[False])
    assert set(grads[True]) == set(params)
    for name, g in grads[False].items():
        assert torch.equal(grads[True][name], g), name


# ------------------------------------------------------ against the JAX's
JAX_CASES = {a: (a, {}) for a in ARCHS}
JAX_CASES.update({f"{LLAMA}-dots": (LLAMA, {"remat_policy": "dots"}),
                  f"{LLAMA}-chunk4": (LLAMA, {"logits_chunk": 4})})


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_remat_loss_and_grads_match_jax(fp32, case):
    """Both packages with remat on (the default), JAX jitted, on JAX's
    weights."""
    arch, changes = JAX_CASES[case]
    jcfg = dataclasses.replace(jax_smoke_config(arch), **changes)
    tcfg = dataclasses.replace(get_smoke_config(arch), **changes)
    assert jcfg.remat and tcfg.remat
    jm, tm = jax_get_model(jcfg), get_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    batch = _batch(tcfg)
    jb = {k: jnp.asarray(v, jnp.float32 if k == "frames" else jnp.int32)
          for k, v in batch.items()}
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(jp, jb)
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    tg, metrics = loss_and_grads(tm, tp, _torch_batch(batch))
    np.testing.assert_allclose(metrics["loss"].item(), float(jl), rtol=1e-4)
    assert set(tg) == set(jg)
    for name, g in tg.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[name]),
                                   err_msg=name, **FP32)


# ------------------------------------------------------ what is recomputed
class _Ops(TorchDispatchMode):
    """Counts each aten op's calls."""

    def __init__(self):
        super().__init__()
        self.calls = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls[func] += 1
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _plain_calls():
    """Each plain version of the norm and the attention counts its calls
    into the yielded Counter while open (on the CPU the models call them
    for the kernels)."""
    calls = collections.Counter()
    saved = [(mod, mod.plain) for mod in (rmsnorm, flash_attention)]

    def counting(name, fn):
        def plain(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return plain

    rmsnorm.plain = counting("rmsnorm", rmsnorm.plain)
    flash_attention.plain = counting("flash_attention",
                                     flash_attention.plain)
    try:
        yield calls
    finally:
        for mod, fn in saved:
            mod.plain = fn


def _counted(cfg) -> dict:
    """Products (``aten.mm``, ``aten.bmm``), plain norms and plain
    attentions of the forward and of the backward of ``cfg``'s loss."""
    model = get_model(cfg)
    leaves = {k: v.requires_grad_() for k, v in _params(cfg).items()}
    batch = _torch_batch(_batch(cfg))
    aten = torch.ops.aten

    def products():
        return {"mm": ops.calls[aten.mm.default],
                "bmm": ops.calls[aten.bmm.default]}

    with _Ops() as ops, _plain_calls() as plain:
        loss, _ = model.loss(leaves, batch)
        fwd = {**products(), **plain}
        torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        total = {**products(), **plain}
    return {"forward": fwd,
            "backward": {k: total[k] - fwd.get(k, 0) for k in total}}


@pytest.mark.parametrize("policy", ["nothing", "dots"])
@pytest.mark.parametrize("arch", [LLAMA, MAMBA2, HYMBA, HUBERT])
def test_the_backward_recomputes_as_the_policy_says(arch, policy):
    base = get_smoke_config(arch)
    L = base.n_layers
    off = _counted(dataclasses.replace(base, remat=False))
    on = _counted(dataclasses.replace(base, remat_policy=policy))
    assert on["forward"] == off["forward"]
    norms = {MAMBA2: 2, HYMBA: 4}.get(arch, 2) * L   # all but the final
    attentions = 0 if arch == MAMBA2 else L
    assert off["backward"].get("rmsnorm", 0) == 0
    assert off["backward"].get("flash_attention", 0) == 0
    assert on["backward"].get("rmsnorm", 0) == norms
    assert on["backward"].get("flash_attention", 0) == attentions
    extra = on["backward"]["mm"] - off["backward"]["mm"]
    if policy == "dots" and arch in DECODERS:
        assert extra == 0      # every product without batch dims kept
    else:
        # every layer product again (the LM head, one mm, is not in a
        # layer) but each layer's last
        assert extra == off["forward"]["mm"] - 1 - L > 0


def test_dots_keeps_the_moe_routers_product_and_no_other_bmm():
    """On mixtral, ``"dots"`` recomputes every ``bmm`` of a layer that
    ``"nothing"`` recomputes but the router's einsum, which has no batch
    dims, and no ``mm``."""
    base = get_smoke_config(MIXTRAL)
    off, nothing, dots = (
        _counted(dataclasses.replace(base, **kw))["backward"]
        for kw in ({"remat": False}, {}, {"remat_policy": "dots"}))
    assert dots["mm"] == off["mm"]
    assert dots["bmm"] - off["bmm"] \
        == nothing["bmm"] - off["bmm"] - base.n_layers > 0


def test_the_recompute_runs_as_many_products_as_the_references():
    """JAX's compiled ``value_and_grad`` of the smoke llama3.2-1b, its
    layers unrolled (``scan_layers=False``), holds as many more dots with
    remat as the port's backward runs more products (``mm`` and ``bmm``,
    attention's plain version on the CPU) with it: each layer's nine but
    the one whose output no backward reads, which XLA drops as dead code
    and torch's early stop never reaches.  Without remat the two count the
    same products."""
    dots, products = {}, {}
    for remat in (False, True):
        jcfg = dataclasses.replace(jax_smoke_config(LLAMA), remat=remat,
                                   scan_layers=False)
        jm = jax_get_model(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        jb = {k: jnp.asarray(v, jnp.int32)
              for k, v in _batch(get_smoke_config(LLAMA)).items()}
        hlo = jax.jit(jax.value_and_grad(jm.loss, has_aux=True)).lower(
            jp, jb).compile().as_text()
        dots[remat] = hlo.count(" dot(")
        got = _counted(dataclasses.replace(get_smoke_config(LLAMA),
                                           remat=remat))
        products[remat] = sum(got[phase][k] for phase in got
                              for k in ("mm", "bmm"))
    L = get_smoke_config(LLAMA).n_layers
    assert dots[False] == products[False]
    assert dots[True] - dots[False] == products[True] - products[False] \
        == (9 - 1) * L


def test_mamba2_and_hymba_take_nothing_whatever_the_policy():
    for arch in (MAMBA2, HYMBA):
        base = get_smoke_config(arch)
        assert _counted(dataclasses.replace(base, remat_policy="dots")) == \
            _counted(base)


# ------------------------------------------------------------ no serving
class _Trace(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_makes_the_same_calls_with_remat_on_and_off(arch,
                                                            monkeypatch):
    """The serving steps run under ``inference_mode``: their op sequences
    with remat on equal those with remat off, and no checkpoint opens."""
    def refuse(*a, **k):
        raise AssertionError("a serving step entered a checkpoint")

    monkeypatch.setattr(layers, "checkpoint", refuse)
    base = get_smoke_config(arch)
    params = _params(base)
    batch = _torch_batch(_batch(base))
    traces = {}
    for remat in (False, True):
        model = get_model(dataclasses.replace(base, remat=remat))
        weights = model.bf16_copy(params)
        with _Trace() as t:
            if base.frontend == "frames":
                make_encode_step(model)(weights, batch)
            else:
                logits, cache = make_prefill_step(model)(
                    weights, {"tokens": batch["tokens"][:, :-1]})
                make_decode_step(model)(weights, batch["tokens"][:, -1:],
                                        cache)
                with torch.inference_mode():
                    model.forward(weights, batch)
        traces[remat] = t.ops
    assert traces[True] == traces[False] and len(traces[True]) > 100
