"""The port's state-space, hybrid and encoder families against the JAX
package's, on the CPU: ``ssd_chunked`` and ``ssd_decode_step``, mamba2-smoke
(2 layers, d_model 64, 8 SSD heads of 16, state 16, chunk 16),
hymba-smoke (2 layers, one global and one with a window of 32) and
hubert-smoke (frames, bidirectional), their zoo tenants, ``serve --arch``
and ``launch.train``, and the reference's faults 6 to 9 in both packages.

JAX initialises the weights (``init(PRNGKey(0))``), which go to numpy and
through ``convert.params_from_numpy`` into the port.  The JAX side runs its
plain jnp model with ``remat=False``: the reference's checkpointing changes
no value, and in eager mode it recompiles each layer on every call.
Tolerances: the SSD in fp32 at rtol 1e-4 / atol 1e-5 (summation order);
logits and loss at test_models.py's rtol=atol=3e-2 (bf16 activations); the
KV and conv caches, bf16 values under 1, at one bf16 ulp scale (rtol 2^-7,
atol 2^-8); the SSD state (fp32, from bf16 inputs) at 3e-2; loss grads in
fp32 activations at rtol 1e-4 / atol 1e-5 and in bf16 within 3e-2 relative
Frobenius, test_torch_autograd.py's bounds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.hybrid as jax_hybrid
import repro.models.mamba2 as jax_mamba2
import repro.models.transformer as jax_transformer
from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch import serve as jax_serve
from repro.launch import train as jax_train
from repro.launch import zoo as jzoo
from repro.models import get_model as jax_get_model
from repro.models import make_encode_step as jax_make_encode_step
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import launch_counts
from repro_torch.launch import serve, train, zoo
from repro_torch.models import (get_model, hybrid, make_decode_step,
                                make_encode_step, make_prefill_step, mamba2,
                                transformer)
from repro_torch.models.convert import numpy_params, params_from_numpy
from test_torch_autograd import (_as_if_on_the_card, _Float32Jnp,  # noqa: F401
                                 launches)

SSD = dict(rtol=1e-4, atol=1e-5)
LOGITS = dict(rtol=3e-2, atol=3e-2)
CACHE = dict(rtol=2 ** -7, atol=2 ** -8)
STATE = dict(rtol=3e-2, atol=3e-2)
MAMBA2, HYMBA, HUBERT = "mamba2-780m", "hymba-1.5b", "hubert-xlarge"


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


_JAX: dict = {}  # (arch, config changes) -> (jitted JAX model, params)


class _Jitted:
    """A JAX model's forward, loss, prefill and decode_step, each under
    ``jax.jit`` (prefill with ``max_len`` static): eager JAX compiles each
    op at each new shape, ~10 s a call for hymba-smoke, where a jitted call
    compiles once in ~1 s."""

    def __init__(self, model):
        self.cfg, self._model, self._fns = model.cfg, model, {}

    def _fn(self, name, **static):
        key = (name, tuple(sorted(static.items())))
        if key not in self._fns:
            fn = getattr(self._model, name)
            self._fns[key] = jax.jit(
                (lambda *a: fn(*a, **static)) if static else fn)
        return self._fns[key]

    def forward(self, params, batch):
        return self._fn("forward")(params, batch)

    def loss(self, params, batch):
        return self._fn("loss")(params, batch)

    def prefill(self, params, batch, **kw):
        return self._fn("prefill", **kw)(params, batch)

    def decode_step(self, params, tokens, cache):
        return self._fn("decode_step")(params, tokens, cache)


def _both(arch: str, **replace):
    """(jitted jax model, jax params, port model, port params) on the same
    weights."""
    key = (arch, tuple(sorted(replace.items())))
    if key not in _JAX:
        jcfg = dataclasses.replace(jax_smoke_config(arch), remat=False,
                                   **replace)
        jm = jax_get_model(jcfg)
        _JAX[key] = (_Jitted(jm), jm.init(jax.random.PRNGKey(0)))
    jm, jp = _JAX[key]
    tm = get_model(dataclasses.replace(get_smoke_config(arch), remat=False,
                                       **replace))
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    return jm, jp, tm, tp


def _tokens(cfg, b: int, s: int, seed: int = 3):
    t = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))
    return jnp.asarray(t, jnp.int32), torch.from_numpy(t)


def _frames(cfg, b: int, s: int, seed: int = 4):
    """hubert's batch in both packages: fp32 frames that each casts to bf16
    (as ``SyntheticFrames`` gives them), and targets."""
    rng = np.random.default_rng(seed)
    fr = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    tg = rng.integers(0, cfg.vocab_size, (b, s))
    return ({"frames": jnp.asarray(fr, jnp.bfloat16),
             "targets": jnp.asarray(tg, jnp.int32)},
            {"frames": torch.from_numpy(fr).bfloat16(),
             "targets": torch.from_numpy(tg)})


def _assert_caches(tc: dict, jc: dict) -> None:
    assert set(tc) == set(jc)
    for name, want in jc.items():
        got = tc[name]
        if name == "pos":
            assert int(got) == int(want)
            continue
        pairs = zip(got, want) if isinstance(want, tuple) else [(got, want)]
        if isinstance(want, tuple):
            assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in pairs:
            assert tuple(g.shape) == tuple(w.shape), name
            np.testing.assert_allclose(_np(g), _np(w), err_msg=name,
                                       **(STATE if name == "ssd" else CACHE))


# ------------------------------------------------------------- SSD core --
def _ssd_inputs(L: int, seed: int = 0, b: int = 2, h: int = 3, p: int = 4,
                n: int = 5):
    """ssd_chunked's inputs as numpy: dt a softplus of a normal draw (the
    models' scale), a_log log U[1, 16), as the models draw them."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return {"x": rng.standard_normal((b, L, h, p)).astype(f),
            "dt": np.log1p(np.exp(rng.standard_normal((b, L, h)) - 2)
                           ).astype(f),
            "a_log": np.log(rng.uniform(1, 16, h)).astype(f),
            "b": rng.standard_normal((b, L, n)).astype(f),
            "c": rng.standard_normal((b, L, n)).astype(f),
            "d_skip": (1 + 0.1 * rng.standard_normal(h)).astype(f)}


@pytest.mark.parametrize("L,chunk", [(16, 16), (48, 16), (41, 16), (5, 8)],
                         ids=["one-chunk", "three-chunks", "padded-tail",
                              "short-padded"])
def test_ssd_chunked_matches_jax(L, chunk):
    a = _ssd_inputs(L)
    y, state = mamba2.ssd_chunked(*(torch.from_numpy(a[k]) for k in a),
                                  chunk=chunk)
    jy, jstate = jax_mamba2.ssd_chunked(*(jnp.asarray(a[k]) for k in a),
                                        chunk=chunk)
    assert y.shape == (2, L, 3, 4) and state.shape == (2, 3, 5, 4)
    assert y.dtype == state.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(jy), **SSD)
    np.testing.assert_allclose(_np(state), _np(jstate), **SSD)


def test_ssd_decode_step_matches_jax_and_steps_the_chunked_form():
    """One step against JAX's, then L steps from a zero state against the
    chunked form over L tokens: every y and the final state."""
    a = _ssd_inputs(11, seed=1)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    state0 = np.random.default_rng(2).standard_normal((2, 3, 5, 4)).astype(
        np.float32)
    args = [a["x"][:, 0], a["dt"][:, 0], a["a_log"], a["b"][:, 0],
            a["c"][:, 0], a["d_skip"]]
    y, s1 = mamba2.ssd_decode_step(torch.from_numpy(state0),
                                   *map(torch.from_numpy, args))
    jy, js1 = jax_mamba2.ssd_decode_step(jnp.asarray(state0),
                                         *map(jnp.asarray, args))
    np.testing.assert_allclose(_np(y), _np(jy), **SSD)
    np.testing.assert_allclose(_np(s1), _np(js1), **SSD)
    state = torch.zeros((2, 3, 5, 4))
    ys = []
    for i in range(11):
        yi, state = mamba2.ssd_decode_step(
            state, t["x"][:, i], t["dt"][:, i], t["a_log"], t["b"][:, i],
            t["c"][:, i], t["d_skip"])
        ys.append(yi)
    full, final = mamba2.ssd_chunked(*t.values(), chunk=4)
    np.testing.assert_allclose(_np(torch.stack(ys, 1)), _np(full), **SSD)
    np.testing.assert_allclose(_np(state), _np(final), **SSD)


def test_ssd_chunked_bf16_inputs_return_bf16():
    a = _ssd_inputs(20, seed=3)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    t["x"] = t["x"].bfloat16()
    y, state = mamba2.ssd_chunked(*t.values(), chunk=8)
    jy, jstate = jax_mamba2.ssd_chunked(
        *(jnp.asarray(a[k], jnp.bfloat16 if k == "x" else jnp.float32)
          for k in a), chunk=8)
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(jy), **CACHE)
    np.testing.assert_allclose(_np(state), _np(jstate), **SSD)


# ------------------------------------------------- the models against JAX --
# (arch, sequence length, prefill max_len or None): mamba2 over 41 tokens,
# three chunks of 16 with a padded tail; hymba over 17 (its windowed layer
# on a positional cache padded to max_len) and 41 (past its window of 32:
# the windowed layer rolls, the global one stays positional)
CASES = {"mamba2": (MAMBA2, 41, None),
         "hymba-positional": (HYMBA, 17, None),
         "hymba-rolling": (HYMBA, 41, None),
         "hymba-max-len": (HYMBA, 17, 40)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_loss_prefill_and_decode_match_jax(case):
    arch, s, max_len = CASES[case]
    jm, jp, tm, tp = _both(arch)
    tj, tt = _tokens(tm.cfg, 2, s)
    full = tm.forward(tp, {"tokens": tt})
    np.testing.assert_allclose(_np(full), _np(jm.forward(jp, {"tokens": tj})),
                               **LOGITS)
    jl, jmet = jm.loss(jp, {"tokens": tj, "targets": tj})
    tl, tmet = tm.loss(tp, {"tokens": tt, "targets": tt})
    np.testing.assert_allclose(float(tl), float(jl), **LOGITS)
    assert set(tmet) == set(jmet) == {"loss"}
    kw = {} if max_len is None else {"max_len": max_len}
    jpre, jc = jm.prefill(jp, {"tokens": tj[:, :-1]}, **kw)
    tpre, tc = tm.prefill(tp, {"tokens": tt[:, :-1]}, **kw)
    assert tpre.shape == jpre.shape == (2, 1, tm.cfg.padded_vocab)
    np.testing.assert_allclose(_np(tpre), _np(jpre), **LOGITS)
    _assert_caches(tc, jc)
    jd, jc2 = jm.decode_step(jp, tj[:, -1:], jc)
    td, tc2 = tm.decode_step(tp, tt[:, -1:], tc)
    np.testing.assert_allclose(_np(td), _np(jd), **LOGITS)
    np.testing.assert_allclose(_np(td[:, 0]), _np(full[:, -1]), **LOGITS)
    _assert_caches(tc2, jc2)
    assert int(tc2["pos"]) == s


def test_hymba_decodes_through_every_cache_kind_at_every_step():
    """hymba-smoke prefills 24 tokens (global layer 0 and windowed layer 1
    both on positional caches of 88 slots) and 36 (layer 1 rolling, 32
    slots), then decodes 8 steps: each step's logits against JAX's, each
    cache against JAX's, and the logits against the windowed forward's
    where the cache holds what the window sees (the rolling run at every
    step, the positional one before position 32: past it the positional
    layer attends unwindowed, fault 5)."""
    jm, jp, tm, tp = _both(HYMBA)
    tj, tt = _tokens(tm.cfg, 1, 44, seed=5)
    full = _np(tm.forward(tp, {"tokens": tt}))
    for prompt, slots in ((24, (88, 88)), (36, (100, 32))):
        _, jc = jm.prefill(jp, {"tokens": tj[:, :prompt]})
        _, tc = tm.prefill(tp, {"tokens": tt[:, :prompt]})
        assert tuple(k.shape[2] for k in tc["k"]) == slots
        for i in range(prompt, prompt + 8):
            jd, jc = jm.decode_step(jp, tj[:, i:i + 1], jc)
            td, tc = tm.decode_step(tp, tt[:, i:i + 1], tc)
            _assert_caches(tc, jc)
            np.testing.assert_allclose(_np(td), _np(jd), **LOGITS)
            if i < 32:  # the positional windowed layer agrees in-window
                np.testing.assert_allclose(_np(td[:, 0]), full[:, i],
                                           **LOGITS)
            if slots[1] == 32:
                np.testing.assert_allclose(_np(td[:, 0]), full[:, i],
                                           **LOGITS)


def test_hubert_forward_loss_and_encode_step_match_jax():
    jm, jp, tm, tp = _both(HUBERT)
    assert not tm.cfg.causal and tm.cfg.frontend == "frames"
    jb, tb = _frames(tm.cfg, 2, 17)
    want = _np(jax_make_encode_step(jm)(jp, jb))
    got = make_encode_step(tm)(tp, tb)
    assert got.is_inference() and got.shape == (2, 17, tm.cfg.padded_vocab)
    np.testing.assert_allclose(_np(got), want, **LOGITS)
    np.testing.assert_allclose(_np(tm.forward(tp, tb)), want, **LOGITS)
    jl, jmet = jm.loss(jp, jb)
    tl, tmet = tm.loss(tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), **LOGITS)
    assert set(tmet) == set(jmet)
    # bidirectional: the first frame's logits move with the last frame
    tb2 = dict(tb, frames=tb["frames"].clone())
    tb2["frames"][:, -1] += 1
    assert not torch.equal(tm.forward(tp, tb2)[:, 0], got[:, 0])


def _fp32(monkeypatch) -> None:
    """Both packages in fp32 activations: the JAX modules read
    ``jnp.bfloat16`` as float32 (``_Float32Jnp``), the port's ACT_DTYPE."""
    for mod in (jax_mamba2, jax_hybrid, jax_transformer):
        monkeypatch.setattr(mod, "jnp", _Float32Jnp())
    for mod in (mamba2, hybrid, transformer):
        monkeypatch.setattr(mod, "ACT_DTYPE", torch.float32)


def _grads_both(arch, monkeypatch, activations, route, s=41):
    if activations == "float32":
        _fp32(monkeypatch)
    if route == "functions":
        _as_if_on_the_card(monkeypatch)
    jm, jp, tm, tp = _both(arch)
    jm = jax_get_model(jm.cfg)  # traced under this test's patches
    if tm.cfg.frontend == "frames":
        jb, tb = _frames(tm.cfg, 2, 17)
        if activations == "float32":
            jb["frames"] = jb["frames"].astype(jnp.float32)
            tb["frames"] = tb["frames"].float()
    else:
        rng = np.random.default_rng(13)
        toks, tgts = (rng.integers(0, tm.cfg.vocab_size, (2, s))
                      for _ in "tt")
        jb = {"tokens": jnp.asarray(toks, jnp.int32),
              "targets": jnp.asarray(tgts, jnp.int32)}
        tb = {"tokens": torch.from_numpy(toks),
              "targets": torch.from_numpy(tgts)}
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(jp,
                                                                       jb)
    for p in tp.values():
        p.requires_grad_()
    tl, _ = tm.loss(tp, tb)
    tl.backward()
    return tm, jl, jg, tl, tp


@pytest.mark.parametrize("activations", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [MAMBA2, HYMBA, HUBERT])
def test_loss_grads_match_jax(launches, monkeypatch, arch, activations):
    """Loss grads against ``jax.value_and_grad``, the norms and attentions
    through the kernels' autograd Functions (each launch its plain
    version): launches per forward as on the card (2L + 1 norms for mamba2
    and hubert, 4L + 1 for hymba; L flash attentions for hymba and
    hubert, none for mamba2)."""
    tm, jl, jg, tl, tp = _grads_both(arch, monkeypatch, activations,
                                     "functions")
    L = tm.cfg.n_layers
    want = {MAMBA2: {"rmsnorm": 2 * L + 1},
            HYMBA: {"rmsnorm": 4 * L + 1, "flash_attention": L},
            HUBERT: {"rmsnorm": 2 * L + 1, "flash_attention": L}}[arch]
    assert dict(launches) == want
    assert set(tp) == set(jg)
    for name, p in tp.items():
        want = _np(jg[name])
        if arch == HUBERT and name == "embed.w":
            # frames skip the token embedding: no grad, and JAX's zeros
            assert p.grad is None and not want.any()
            continue
        got = _np(p.grad)
        assert got.shape == want.shape, name
        assert np.abs(got).max() > 0, name
        if activations == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                       err_msg=name)
        else:
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel <= 3e-2, (name, rel)
    np.testing.assert_allclose(tl.item(), float(jl),
                               rtol=1e-4 if activations == "float32"
                               else 3e-2)


def test_models_launch_no_kernel_on_the_cpu():
    for arch in (MAMBA2, HYMBA):
        model = get_model(get_smoke_config(arch))
        params = model.bf16_copy(model.init(torch.Generator().manual_seed(0)))
        toks = torch.randint(0, 100, (1, 9))
        before = launch_counts()
        _, cache = model.prefill(params, {"tokens": toks})
        model.decode_step(params, toks[:, -1:], cache)
        assert launch_counts() == before


# --------------------------------------------------------- model details --
def test_bf16_copy_casts_what_jax_casts_and_changes_no_value():
    for arch, fp32 in ((MAMBA2, mamba2._FP32), (HYMBA, hybrid._FP32)):
        _, _, tm, tp = _both(arch)
        copy = tm.bf16_copy(tp)
        for name, v in copy.items():
            want = torch.float32 if name in fp32 else torch.bfloat16
            assert v.dtype == want, name
        assert {"layers.a_log", "layers.dt_bias"} <= {
            k.replace("ssm.", "") for k in fp32}
        _, tt = _tokens(tm.cfg, 1, 9)
        assert torch.equal(tm.forward(copy, {"tokens": tt}),
                           tm.forward(tp, {"tokens": tt}))


def test_decode_steps_are_functional_and_hymba_raises_past_the_cache():
    for arch in (MAMBA2, HYMBA):
        _, _, tm, tp = _both(arch)
        _, tt = _tokens(tm.cfg, 1, 8)
        _, cache = tm.prefill(tp, {"tokens": tt}, max_len=9)
        before = {k: [t.clone() for t in v] if isinstance(v, tuple)
                  else v.clone() for k, v in cache.items()}
        _, cache2 = tm.decode_step(tp, tt[:, -1:], cache)
        for k, v in cache.items():
            for a, b in zip(v if isinstance(v, tuple) else [v],
                            before[k] if isinstance(v, tuple)
                            else [before[k]]):
                assert torch.equal(a, b), k
        assert not torch.equal(cache2["ssd"], cache["ssd"])
        if arch == HYMBA:  # JAX clamps this write onto the last slot
            with pytest.raises(ValueError, match="past layer 0"):
                tm.decode_step(tp, tt[:, -1:], cache2)
        else:  # an SSM cache has no slots to run out of
            tm.decode_step(tp, tt[:, -1:], cache2)


def test_init_caches_have_the_reference_shapes():
    for arch in (MAMBA2, HYMBA):
        jm, _, tm, _ = _both(arch)
        for max_len in (8, 32, 50):
            jc = jax_get_model(jm.cfg).init_cache(2, max_len)
            tc = tm.init_cache(2, max_len, device="cpu")
            assert set(tc) == set(jc)
            for k, v in jc.items():
                got = tc[k] if isinstance(v, tuple) else [tc[k]]
                for g, w in zip(got, v if isinstance(v, tuple) else [v]):
                    assert tuple(g.shape) == tuple(w.shape), (arch, k)
                    assert str(g.dtype).split(".")[-1] == str(w.dtype)


def test_ssm_inits_draw_as_jax_does():
    """init on a Generator and numpy_params: A_log = log U[1, 16), the dt
    bias softplus^-1 U[1e-3, 1e-1), as JAX's init draws them."""
    cfg = get_smoke_config(MAMBA2)
    model = get_model(dataclasses.replace(cfg, n_layers=64))
    jm = jax_get_model(dataclasses.replace(jax_smoke_config(MAMBA2),
                                           n_layers=64))
    jp = jm.init(jax.random.PRNGKey(0))
    for params in (model.init(torch.Generator().manual_seed(0)),
                   numpy_params(model, seed=0), jp):
        a = np.exp(_np(params["layers.a_log"]))
        dt = np.log1p(np.exp(_np(params["layers.dt_bias"])))
        assert 1 <= a.min() < 1.5 and 15.5 < a.max() < 16
        assert 1e-3 <= dt.min() < 3e-3 and 0.098 < dt.max() <= 0.1 + 1e-6


# ------------------------------------------------- the reference's faults --
def test_fault_6_jax_serve_cannot_prefill_mamba2_and_the_port_can(capsys):
    """ROADMAP.md Queue 3, fault 6: the reference's ``serve --arch``
    passes ``max_len`` to every model's prefill, and ``Mamba2LM.prefill``
    takes none; the port's takes it and ignores it."""
    with pytest.raises(TypeError, match="max_len"):
        jax_serve.main(["--arch", MAMBA2, "--smoke", "--batch", "1",
                        "--prompt-len", "8", "--gen", "1"])
    jm, jp, tm, tp = _both(MAMBA2)
    tj, tt = _tokens(tm.cfg, 1, 8)
    a, ca = tm.prefill(tp, {"tokens": tt}, max_len=100)
    b, cb = tm.prefill(tp, {"tokens": tt})
    assert torch.equal(a, b) and torch.equal(ca["ssd"], cb["ssd"])
    serve.main(["--arch", MAMBA2, "--smoke", "--device", "cpu", "--batch",
                "1", "--prompt-len", "8", "--gen", "1"])
    assert "arch=mamba2-780m-smoke batch=1 prompt=8 gen=1" in \
        capsys.readouterr().out


@pytest.mark.parametrize("arch", [HYMBA, "mixtral-8x22b"])
def test_fault_7_a_padded_cache_of_window_length_decodes_as_rolling(arch):
    """ROADMAP.md Queue 3, fault 7: a prompt of 16 tokens prefilled with
    max_len equal to the window (32) pads the windowed layers' caches to
    32 slots, and decode_step takes any cache of window length as
    rolling: it shifts out slot 0, a real token, and attends to the
    padding.  One step off the forward's logits at position 16 in both
    packages; with max_len 33 the cache stays positional and agrees.
    Tokens randint(PRNGKey(5), (1, 17)); mixtral routes without drops."""
    extra = {}
    if arch != HYMBA:
        cfg = get_smoke_config(arch)
        extra = dict(capacity_factor=cfg.n_experts / cfg.experts_per_token)
    jm, jp, tm, tp = _both(arch, **extra)
    toks = jax.random.randint(jax.random.PRNGKey(5), (1, 17), 0,
                              tm.cfg.vocab_size)
    assert tm.cfg.window == 32
    runs = {"jax": (jm, jp, toks),
            "port": (tm, tp, torch.from_numpy(np.array(toks)))}
    for name, (model, params, tokens) in runs.items():
        want = _np(model.forward(params, {"tokens": tokens}))[:, 16]
        err = {}
        for max_len in (32, 33):
            _, cache = model.prefill(params, {"tokens": tokens[:, :16]},
                                     max_len=max_len)
            lg, _ = model.decode_step(params, tokens[:, 16:17], cache)
            err[max_len] = float(np.abs(_np(lg)[:, 0] - want).max())
        assert err[32] > 0.1 and err[33] < 3e-2, (name, err)


def test_fault_8_neither_launcher_trains_hubert(capsys):
    """ROADMAP.md Queue 3, fault 8: ``launch.train`` feeds token batches
    and hubert's frontend reads ``batch['frames']``: the reference stops
    with a KeyError at its first step, the port exits before it builds the
    model, naming the fault."""
    with pytest.raises(KeyError, match="frames"):
        jax_train.main(["--arch", HUBERT, "--smoke", "--steps", "1",
                        "--batch", "2", "--seq", "8"])
    with pytest.raises(SystemExit, match="fault 8"):
        train.main(["--arch", HUBERT, "--smoke", "--device", "cpu",
                    "--steps", "1", "--batch", "2", "--seq", "8"])
    # and the encoder has no decode serving in either
    for main in (jax_serve.main, lambda a: serve.main(a + ["--device",
                                                            "cpu"])):
        with pytest.raises(SystemExit, match="encoder-only"):
            main(["--arch", HUBERT, "--smoke"])


def test_fault_9_jax_ssd_grads_go_nan_where_the_port_stays_finite():
    """ROADMAP.md Queue 3, fault 9: at mamba2-780m's own chunk of 256 a
    256-token sequence sums up to ~400 of -dt * A above the diagonal of a
    chunk; the reference takes ``where(causal, exp(diff), 0)`` and its
    backward multiplies the masked inf by 0: NaN grads (mamba2-smoke with
    ssm_chunk=256, tokens from default_rng(3)).  The port exponentiates
    -inf there: the same loss, finite grads."""
    jm, jp, tm, tp = _both(MAMBA2, ssm_chunk=256)
    tj, tt = _tokens(tm.cfg, 2, 256)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        jax_get_model(jm.cfg).loss, has_aux=True))(
        jp, {"tokens": tj, "targets": tj})
    assert np.isnan(_np(jg["layers.in_proj.w"])).any()
    for p in tp.values():
        p.requires_grad_()
    tl, _ = tm.loss(tp, {"tokens": tt, "targets": tt})
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), **LOGITS)
    assert all(bool(torch.isfinite(p.grad).all()) for p in tp.values())


# ------------------------------------------------------- the zoo tenants --
def _jax_model_tenant(flavor: str, seed: int = 0):
    """The JAX model tenant's model (jitted), weights and tokens
    (zoo.py:120-128)."""
    model = jax_get_model(jax_smoke_config(jzoo.FLAVOR_ARCHS[flavor]))
    params = model.init(jax.random.PRNGKey(seed))
    model = _Jitted(model)
    toks = jax.random.randint(jax.random.PRNGKey(seed + 1), (1, 16), 0,
                              model.cfg.vocab_size)
    return model, params, toks


@pytest.mark.parametrize("flavor", ["ssm", "hybrid"])
def test_model_tenants_match_the_jax_tenants(flavor):
    """The ssm and hybrid tenants' prefill slab and decode burst against
    the JAX model's prefill and decode step on the JAX tenant's weights and
    tokens (zoo.py:120-143), and their chunking against the JAX tenant's
    formulas, which no flavor changes (zoo.py:173-193; the kernel tenant
    builds in a fraction of a model tenant's time)."""
    model, params, toks = _jax_model_tenant(flavor)
    tenant = zoo.ZooTenant(
        "t", flavor=flavor, device="cpu", shapes=zoo.ZOO_SHAPES,
        params=params_from_numpy({k: np.asarray(v) for k, v in
                                  params.items()}, "cpu"),
        tokens=torch.from_numpy(np.array(toks)).long(), decode_steps=2)
    assert tenant.config == zoo.model_config(flavor, zoo.ZOO_SHAPES)
    logits, cache0 = model.prefill(params, {"tokens": toks})
    dec, _ = model.decode_step(params, toks[:, -1:], cache0)
    np.testing.assert_allclose(_np(tenant.prefill_slab()), _np(logits),
                               **LOGITS)
    np.testing.assert_allclose(_np(tenant.cache0["ssd"]),
                               _np(cache0["ssd"]), **STATE)
    np.testing.assert_allclose(_np(tenant.decode_burst()), _np(dec),
                               **LOGITS)
    theirs = jzoo.ZooTenant("t", flavor="kernel")
    assert tenant.kv_bytes_per_token() == theirs.kv_bytes_per_token()
    for prompt in (1, 1024, 1025):
        r = zoo.ServeRequest(0, prompt, 64)
        assert tenant.prefill_chunks(r) == theirs.prefill_chunks(r)


@pytest.mark.parametrize("flavor", ["ssm", "hybrid"])
def test_model_tenants_serve_through_the_zoo(flavor):
    tenants = zoo.default_zoo({"steady": flavor, "burst": "kernel"},
                              device="cpu", shapes=zoo.ZOO_SHAPES)
    zoo.warm_zoo(tenants)
    trace = serve.bursty_serving_trace(
        n_steady=3, n_burst=3, burst_at=0.0, steady_prompts=(64,),
        steady_gens=(64,), burst_prompts=(64,), burst_gens=(64,), seed=2)
    stats = serve.run_zoo(trace, tenants, timeout_s=120.0)
    assert stats.result.n_rejected == 0
    assert all(st.done for st in stats.result.per_dag.values())
    assert set(stats.tokens_per_s_by_tenant) == {"steady", "burst"}


# ----------------------------------------------------------- the CLIs --
@pytest.mark.parametrize("arch", [MAMBA2, HYMBA])
def test_serve_arch_runs_the_ssm_and_hybrid_families(capsys, arch):
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "40", "--gen", "3", "--orchestrate"])
    out = capsys.readouterr().out
    name = get_smoke_config(arch).name
    assert f"arch={name} batch=2 prompt=40 gen=3" in out
    assert "orchestrated: 16 TAOs" in out
    run = serve.run_arch(arch, smoke=True, batch=2, prompt_len=40, gen=3,
                         device="cpu")
    assert int(run["cache"]["pos"]) == 43
    assert torch.equal(run["logits"][:, -1].argmax(-1),
                       run["out_tokens"][:, 0])
    if arch == HYMBA:  # window 32: layer 0 global (40 + 3 + 1), 1 rolling
        assert [k.shape[2] for k in run["cache"]["k"]] == [44, 32]


def test_run_encode_serves_hubert_through_the_encode_step(capsys):
    cfg = get_smoke_config(HUBERT)
    out = serve.run_encode(config=cfg, device="cpu", repeats=2)
    assert f"arch={cfg.name} batch=4 frames=500 encode:" in \
        capsys.readouterr().out
    assert out["logits"].shape == (4, 500, cfg.padded_vocab)
    assert out["batch"]["frames"].dtype == torch.bfloat16
    assert len(out["encode_s"]) == 2
    assert torch.equal(out["logits"], out["model"].forward(out["weights"],
                                                           out["batch"]))


@pytest.mark.parametrize("arch", [MAMBA2, HYMBA])
def test_launch_train_runs_the_ssm_and_hybrid_families(arch):
    out = train.run(arch, smoke=True, steps=3, batch=2, seq=16,
                    device="cpu")
    assert out["model"].cfg.name == get_smoke_config(arch).name
    assert np.isfinite(out["losses"] + out["grad_norms"]).all()
    assert len(out["losses"]) == 3 and int(out["opt"].step) == 3


def test_prefill_and_decode_steps_run_in_inference_mode():
    for arch in (MAMBA2, HYMBA):
        model = get_model(get_smoke_config(arch))
        params = model.init(torch.Generator().manual_seed(0))
        toks = torch.randint(0, 100, (2, 17))
        pre, cache = make_prefill_step(model)(params, {"tokens": toks})
        dec, cache2 = make_decode_step(model)(params, toks[:, -1:], cache)
        assert torch.is_grad_enabled()
        assert pre.is_inference() and dec.is_inference()
        assert cache2["ssd"].is_inference()
