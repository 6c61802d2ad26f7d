"""The port's training path against the JAX package's, on the CPU:
``make_train_step`` on JAX's weights (fp32 activations at rtol 1e-4 / atol
1e-5, the models' bf16 at 3e-2 relative Frobenius: the bounds of
tests/test_torch_autograd.py), through the kernels' Functions and through
the plain versions; the training DAG and its simulation; the threaded
training run against sequential training; and ``launch.train``'s entry
point, plain, orchestrated and resumed."""
import dataclasses
import shutil
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.hybrid as jax_hybrid
import repro.models.mamba2 as jax_mamba2
import repro.models.transformer as jax_transformer
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import hikey960 as jax_hikey960
from repro.core import make_policy as jax_make_policy
from repro.core.train_orchestrator import \
    build_training_dag as jax_build_training_dag
from repro.core.train_orchestrator import \
    simulate_training as jax_simulate_training
from repro.models import get_model as jax_get_model
from repro.models import make_train_step as jax_make_train_step
from repro.models.losses import lm_cross_entropy as jax_lm_cross_entropy
from repro.optimizer import adamw_init as jax_adamw_init
from repro.optimizer import cosine_schedule as jax_cosine_schedule
from repro_torch.configs import get_smoke_config
from repro_torch.core import hikey960, make_policy
from repro_torch.data import SyntheticLM
from repro_torch.launch import train
from repro_torch.models import (get_model, hybrid, loss_and_grads,
                                make_train_step, mamba2, transformer)
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.losses import lm_cross_entropy
from repro_torch.optimizer import adamw_init, adamw_update, cosine_schedule
from repro_torch.train_orchestrator import (GradAccumulator,
                                            build_training_dag,
                                            run_training_threaded,
                                            simulate_training)
from test_torch_autograd import (_as_if_on_the_card, _Float32Jnp,  # noqa: F401
                                 launches)

ARCH = "llama3.2-1b"
STEPS = 3
_JAX_RUNS: dict = {}  # (arch, activations) -> JAX's trajectory


def _batches(vocab: int, frames: int = 0) -> list:
    """STEPS batches of 2 x 16 tokens, or with ``frames`` (a d_model) of
    2 x 16 frames (fp32 draws that each package casts to bf16) and
    targets."""
    rng = np.random.default_rng(21)
    out = []
    for _ in range(STEPS):
        t = rng.integers(0, vocab, (2, 17)).astype(np.int32)
        out.append({"tokens": t[:, :-1], "targets": t[:, 1:]})
        if frames:
            out[-1]["frames"] = rng.standard_normal(
                (2, 16, frames)).astype(np.float32)
            del out[-1]["tokens"]
    return out


def _frames_width(cfg) -> int:
    return cfg.d_model if cfg.frontend == "frames" else 0


def _jax_run(activations: str, arch: str = ARCH) -> dict:
    """JAX's make_train_step for STEPS steps on ``arch``'s smoke config."""
    if (arch, activations) not in _JAX_RUNS:
        jm = jax_get_model(jax_smoke_config(arch))
        params = jm.init(jax.random.PRNGKey(0))
        init = {k: np.asarray(v) for k, v in params.items()}
        opt = jax_adamw_init(params)
        step = jax.jit(jax_make_train_step(jm, jax_cosine_schedule(
            1e-3, warmup_steps=2, total_steps=STEPS)))
        metrics, states = [], []
        for b in _batches(jm.cfg.vocab_size, _frames_width(jm.cfg)):
            params, opt, m = step(params, opt, {
                k: jnp.asarray(v, jnp.bfloat16 if k == "frames" else None)
                for k, v in b.items()})
            metrics.append({k: float(m[k])
                            for k in ("loss", "grad_norm", "lr")})
            states.append({name: {k: np.asarray(v) for k, v in tree.items()}
                           for name, tree in (("params", params),
                                              ("mu", opt.mu),
                                              ("nu", opt.nu))})
        _JAX_RUNS[arch, activations] = {
            "init": init, "metrics": metrics, "states": states,
            "step": int(opt.step)}
    return _JAX_RUNS[arch, activations]


def _rel(got: torch.Tensor, want: np.ndarray) -> float:
    return float(np.linalg.norm(got.float().numpy() - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("activations", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["functions", "plain"])
def test_make_train_step_matches_jax(launches, monkeypatch, route,
                                     activations):
    _check_train_step(launches, monkeypatch, ARCH, route, activations)


@pytest.mark.parametrize("activations", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "moonshot-v1-16b-a3b"])
def test_make_train_step_matches_jax_on_the_moe_decoders(
        launches, monkeypatch, arch, activations):
    """mixtral-smoke (4 experts top-2, window 32) and moonshot-smoke (8
    experts top-2), 16 tokens a row at their own capacity, through the
    kernels' Functions: the router, the dispatch and the experts' grads.

    In fp32 the three steps agree at rtol 1e-4.  In bf16 the two packages'
    router logits differ by bf16 roundings (up to ~2e-3 here), and a token
    whose k-th and (k+1)-th logits lie closer than that goes to other
    experts in each package: top-k is discontinuous there, in either
    package, and the two are other functions.  So the bf16 steps take the
    loss of the tokens that route alike (``_MaskedLoss``,
    ``_routed_alike``), and every step's metrics, params and moments agree
    at 3e-2."""
    if activations == "float32":
        _check_train_step(launches, monkeypatch, arch, "functions",
                          activations)
    else:
        _check_masked_moe_train_steps(launches, monkeypatch, arch)


@pytest.mark.parametrize("activations", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b",
                                  "hubert-xlarge"])
def test_make_train_step_matches_jax_on_the_ssm_hybrid_and_encoder(
        launches, monkeypatch, arch, activations):
    """mamba2-smoke, hymba-smoke and hubert-smoke (on 2 x 16 frames),
    through the kernels' Functions.  In fp32 every step's metrics, params
    and moments at rtol 1e-4 / atol 1e-5.  In bf16 every step's loss and
    grad norm at 3e-2, and the first step's moments (the grads of the same
    weights) at 3e-2 relative Frobenius.  The params are left out in bf16:
    AdamW's first step moves an element by lr * sign(grad), and an element
    whose grad lies within the two packages' bf16 noise of 0 steps the
    other way (one of mamba2-smoke's 320 zero-initialised conv biases:
    0.113 relative on that parameter), and the later steps' grads follow
    the params apart.  hubert's token embedding, which frames skip, gets
    zero grads in both packages and moves by the weight decay alone."""
    _check_train_step(launches, monkeypatch, arch, "functions", activations,
                      bf16_state_steps=1)


class _MaskedLoss:
    """``model`` with a loss of the mean cross-entropy of the tokens that
    ``batch["mask"]`` keeps (``ce``: the package's lm_cross_entropy), and
    the model's metrics."""

    def __init__(self, model, ce, exp):
        self.model, self.ce, self.exp = model, ce, exp

    def loss(self, params, batch):
        logits = self.model.forward(params, {"tokens": batch["tokens"]})
        loss = self.ce(logits, batch["targets"],
                       onehot=self.model.cfg.ce_onehot, mask=batch["mask"])
        return loss, {"loss": loss, "ppl_proxy": self.exp(loss)}


def _router_logits(module, forward) -> list:
    """Each layer's fp32 router logits (B, S, E) as ``module.moe_ffn``
    computes them, over one ``forward()``."""
    calls, inner = [], module.moe_ffn

    def logged(x, router_w, *rest, **kw):
        calls.append(torch.from_numpy(np.asarray(x, np.float32))
                     @ torch.from_numpy(np.asarray(router_w, np.float32))
                     if isinstance(x, jax.Array) else
                     x.float() @ router_w.float())
        return inner(x, router_w, *rest, **kw)

    module.moe_ffn = logged
    try:
        forward()
    finally:
        module.moe_ffn = inner
    return calls


def _routed_alike(ours: list, theirs: list, k: int, capacity: int
                  ) -> torch.Tensor:
    """(B, S) float mask of the tokens whose loss is one function in both
    packages: in every layer the same top-k and the same kept assignments
    (capacity rule: fewer than ``capacity`` earlier tokens of the row chose
    the expert).  A token that differs in a layer before the last reaches
    every later token of its row through the next layer's attention, and
    takes them out too."""
    bad = None
    for i, (a, b) in enumerate(zip(ours, theirs)):
        sel = [torch.zeros(x.shape, dtype=torch.bool).scatter_(
            -1, x.topk(k, dim=-1).indices, True) for x in (a, b)]
        keep = [m & (m.long().cumsum(dim=1) <= capacity) for m in sel]
        off = ~((sel[0] == sel[1]).all(-1) & (keep[0] == keep[1]).all(-1))
        if i < len(ours) - 1:
            off = off.long().cummax(dim=1).values.bool()
        bad = off if bad is None else bad | off
    return (~bad).float()


def _check_masked_moe_train_steps(launches, monkeypatch, arch):
    """Both packages' make_train_step on ``_MaskedLoss`` in bf16, from
    JAX's init, for STEPS steps; before each, the mask of the tokens that
    route alike (eager forwards of both on their own params)."""
    jcfg = jax_smoke_config(arch)
    jm = jax_get_model(jcfg)
    eager = jax_get_model(dataclasses.replace(jcfg, scan_layers=False,
                                              remat=False))
    jparams = jm.init(jax.random.PRNGKey(0))
    jopt = jax_adamw_init(jparams)
    sched = dict(warmup_steps=2, total_steps=STEPS)
    jstep = jax.jit(jax_make_train_step(_MaskedLoss(
        jm, jax_lm_cross_entropy, lambda x: jnp.exp(jnp.minimum(x, 20.0))),
        jax_cosine_schedule(1e-3, **sched)))
    _as_if_on_the_card(monkeypatch)
    model = get_model(get_smoke_config(arch))
    cfg = model.cfg
    params = params_from_numpy({k: np.asarray(v)
                                for k, v in jparams.items()}, "cpu")
    opt = adamw_init(params)
    step = make_train_step(_MaskedLoss(
        model, lm_cross_entropy,
        lambda x: torch.exp(torch.clamp(x, max=20.0))),
        cosine_schedule(1e-3, **sched))
    layers = cfg.n_layers
    kept = []
    for b in _batches(cfg.vocab_size):
        ours = _router_logits(transformer, lambda: model.forward(
            params, {"tokens": torch.from_numpy(b["tokens"])}))
        theirs = _router_logits(jax_transformer, lambda: eager.forward(
            jparams, {"tokens": jnp.asarray(b["tokens"])}))
        mask = _routed_alike(ours, theirs, cfg.experts_per_token,
                             cfg.moe_capacity(b["tokens"].shape[1]))
        kept.append(float(mask.mean()))
        launches.clear()
        params, opt, m = step(params, opt, {
            **{k: torch.from_numpy(v) for k, v in b.items()}, "mask": mask})
        # the forward's, and the backward's recompute of each layer (remat,
        # the config's default)
        assert cfg.remat
        assert dict(launches) == {"rmsnorm": 4 * layers + 1,
                                  "flash_attention": 2 * layers}
        jparams, jopt, jmet = jstep(jparams, jopt, {
            **{k: jnp.asarray(v) for k, v in b.items()},
            "mask": jnp.asarray(mask.numpy())})
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(m[k].item(), float(jmet[k]),
                                       rtol=3e-2, err_msg=k)
        for tree, ref in ((params, jparams), (opt.mu, jopt.mu),
                          (opt.nu, jopt.nu)):
            assert set(tree) == set(ref)
            for name, got in tree.items():
                assert _rel(got, np.asarray(ref[name])) <= 3e-2, name
    assert int(opt.step) == int(jopt.step) == STEPS
    # the test holds most of each batch: the mask is no way round it
    assert min(kept) >= 0.5, kept


def _check_train_step(launches, monkeypatch, arch, route, activations,
                      bf16_state_steps: int = STEPS):
    """``route``'s make_train_step for STEPS steps against JAX's: each
    step's metrics, params and moments; in bf16 the params and moments of
    the first ``bf16_state_steps`` steps only, and with that below STEPS
    the moments alone."""
    if activations == "float32":
        for mod in (jax_transformer, jax_mamba2, jax_hybrid):
            monkeypatch.setattr(mod, "jnp", _Float32Jnp())
        for mod in (transformer, mamba2, hybrid):
            monkeypatch.setattr(mod, "ACT_DTYPE", torch.float32)
    want = _jax_run(activations, arch)
    if route == "functions":
        _as_if_on_the_card(monkeypatch)
    model = get_model(get_smoke_config(arch))
    params = params_from_numpy(want["init"], "cpu")
    opt = adamw_init(params)
    step = make_train_step(model, cosine_schedule(1e-3, warmup_steps=2,
                                                  total_steps=STEPS))
    decoder = model.cfg.family in ("decoder", "encoder")
    for i, (b, jm, ref) in enumerate(zip(_batches(
            model.cfg.vocab_size, _frames_width(model.cfg)),
            want["metrics"], want["states"])):
        params, opt, m = step(params, opt, {
            k: torch.from_numpy(v).to(torch.bfloat16 if k == "frames"
                                      else None) for k, v in b.items()})
        assert set(m) == {"loss", "grad_norm", "lr"} | (
            {"ppl_proxy"} if decoder else set())
        assert not any(v.requires_grad for v in m.values())
        rtol = 1e-4 if activations == "float32" else 3e-2
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(m[k].item(), jm[k], rtol=rtol,
                                       err_msg=k)
        held = (("params", params), ("mu", opt.mu), ("nu", opt.nu))
        if activations == "bfloat16" and bf16_state_steps < STEPS:
            held = held[1:] if i < bf16_state_steps else ()
        for part, tree in held:
            assert set(tree) == set(ref[part])
            for name, got in tree.items():
                assert got.dtype == torch.float32
                if activations == "float32":
                    np.testing.assert_allclose(got.numpy(), ref[part][name],
                                               rtol=1e-4, atol=1e-5,
                                               err_msg=name)
                else:
                    assert _rel(got, ref[part][name]) <= 3e-2, name
    layers = model.cfg.n_layers
    # a step's forward, and under remat (the configs' default) the
    # backward's recompute of each layer: every norm but the final one and
    # every attention again
    again = 2 if model.cfg.remat else 1
    per_step = {"decoder": {"rmsnorm": again * 2 * layers + 1,
                            "flash_attention": again * layers},
                "ssm": {"rmsnorm": again * 2 * layers + 1},
                "hybrid": {"rmsnorm": again * 4 * layers + 1,
                           "flash_attention": again * layers}}
    per_step["encoder"] = per_step["decoder"]
    assert dict(launches) == ({k: STEPS * n for k, n in per_step[
        model.cfg.family].items()} if route == "functions" else {})
    assert int(opt.step) == want["step"] == STEPS


def test_train_step_leaves_its_inputs_and_turns_grad_on_itself():
    model = get_model(get_smoke_config(ARCH))
    params = model.init(torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in params.items()}
    opt = adamw_init(params)
    toks = torch.randint(0, 503, (2, 9), generator=torch.Generator()
                         .manual_seed(2))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    with torch.inference_mode():  # a caller's mode does not leak in
        new, new_opt, m = make_train_step(model)(params, opt, batch)
    for k, v in params.items():
        assert torch.equal(v, before[k]) and not v.requires_grad
        assert not torch.equal(new[k], v)
    assert int(opt.step) == 0 and int(new_opt.step) == 1
    assert not bool(opt.mu["embed.w"].any())
    assert float(m["lr"]) == pytest.approx(3e-4)


# ------------------------------------------------- the training DAG --
@pytest.mark.parametrize("n_steps,n_mb,width", [(3, 4, 1), (1, 1, 1),
                                                (2, 3, 2)])
def test_build_training_dag_matches_jax(n_steps, n_mb, width):
    def shape(dag):
        return [(n.id, n.type, n.width_hint, n.work,
                 sorted(p.id for p in n.parents)) for n in dag.nodes]
    ours = build_training_dag(n_steps, n_mb, width_hint=width)
    theirs = jax_build_training_dag(n_steps, n_mb, width_hint=width)
    assert shape(ours) == shape(theirs)
    ours.assign_criticality()
    theirs.assign_criticality()
    assert ours.critical_path_length() == theirs.critical_path_length() \
        == 3 * n_steps


@pytest.mark.parametrize("policy", ["molding:crit-ptt", "homogeneous"])
def test_simulate_training_matches_jax(policy):
    ours = simulate_training(5, 4, hikey960(), make_policy(policy), seed=0)
    theirs = jax_simulate_training(5, 4, jax_hikey960(),
                                   jax_make_policy(policy), seed=0)
    assert ours.completed == theirs.completed == 5 * (4 + 2)
    assert ours.makespan == theirs.makespan


# ------------------------------------------------ the threaded run --
def _smoke():
    model = get_model(get_smoke_config(ARCH))
    return model, model.init(torch.Generator().manual_seed(0))


def _threaded_batches(vocab: int) -> list:
    g = torch.Generator().manual_seed(5)
    out = []
    for _ in range(2):           # 2 steps
        mbs = []
        for _ in range(3):       # 3 microbatches
            t = torch.randint(0, vocab, (2, 17), generator=g)
            mbs.append({"tokens": t[:, :-1], "targets": t[:, 1:]})
        out.append(mbs)
    return out


def test_training_threaded_real_grads_match_sequential():
    """The DAG-scheduled training matches plain sequential training (the
    twin of tests/test_orchestrators.py's)."""
    model, params = _smoke()
    opt = adamw_init(params)

    def grad_fn(p, b):
        return loss_and_grads(model, p, b)

    def update_fn(p, g, o):
        return adamw_update(p, g, o, lr=1e-3)

    batches = _threaded_batches(model.cfg.vocab_size)
    stats = run_training_threaded(
        hikey960(), make_policy("molding:crit-ptt"), params, opt,
        grad_fn, update_fn, batches, timeout_s=300)
    assert stats["completed"] == 2 * (3 + 2)
    assert len(stats["losses"]) == 6
    assert stats["ptt"]["fwdbwd"].shape[1] == len(stats["widths"])

    p_ref, o_ref = params, opt
    for mbs in batches:
        grads = None
        for mb in mbs:
            g, _ = grad_fn(p_ref, mb)
            grads = g if grads is None else {k: grads[k] + g[k] for k in g}
        grads = {k: g / len(mbs) for k, g in grads.items()}
        p_ref, o_ref = update_fn(p_ref, grads, o_ref)
    assert int(stats["opt"].step) == int(o_ref.step) == 2
    for k in p_ref:
        # the sums of three microbatches in another order
        torch.testing.assert_close(stats["params"][k], p_ref[k], rtol=1e-5,
                                   atol=1e-6)


def test_threaded_training_keeps_no_tensor_once_it_returns():
    """The run's TAOs reference each other, so without clearing their
    payloads the state and the accumulator's buffers would outlive the run
    until the cyclic collector ran: on the card, another 3 copies of the
    parameters."""
    import gc
    import weakref

    model, params = _smoke()
    opt = adamw_init(params)
    batches = _threaded_batches(model.cfg.vocab_size)[:1]
    first = weakref.ref(params["embed.w"])
    gc.disable()
    try:
        stats = run_training_threaded(
            hikey960(), make_policy("molding:crit-ptt"), params, opt,
            lambda p, b: loss_and_grads(model, p, b),
            lambda p, g, o: adamw_update(p, g, o, lr=1e-3), batches)
        del params, opt
        assert first() is None
        last = weakref.ref(stats["params"]["embed.w"])
        del stats
        assert last() is None
    finally:
        gc.enable()


def test_grad_accumulator_loses_no_add_under_contention():
    like = {"a": torch.zeros(3), "b": torch.zeros(2, 2)}
    acc = GradAccumulator(like)
    n_threads, per_thread = 16, 50
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            acc.add({"a": torch.ones(3), "b": torch.ones(2, 2)})
            for _ in range(per_thread)]) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    total, n = acc.drain()
    assert n == n_threads * per_thread
    assert bool((total["a"] == n).all()) and bool((total["b"] == n).all())
    again, zero = acc.drain()
    assert zero == 0 and not bool(again["a"].any())


# ------------------------------------------------------ launch.train --
SMOKE_ARGS = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
              "--seq", "16"]


def test_launch_train_main_prints_the_reference_lines(capsys):
    train.main(SMOKE_ARGS + ["--steps", "6"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "arch=llama3.2-1b-smoke params=139,584"
    steps = [ln for ln in lines if ln.startswith("step ")]
    assert [int(ln.split()[1]) for ln in steps] == [0, 5]
    assert all(" loss=" in ln and " gnorm=" in ln and " lr=" in ln
               for ln in steps)
    assert lines[-1].startswith("done: 6 steps in ")


def test_launch_train_run_learns_and_follows_the_schedule():
    out = train.run(ARCH, smoke=True, steps=6, batch=2, seq=16,
                    device="cpu")
    assert np.isfinite(out["losses"]).all() and len(out["losses"]) == 6
    assert len(out["step_s"]) == len(out["grad_norms"]) == 6
    sched = cosine_schedule(3e-4, warmup_steps=2, total_steps=6)
    np.testing.assert_allclose(out["lrs"], [float(sched(s + 1))
                                            for s in range(6)], rtol=1e-6)
    assert int(out["opt"].step) == 6
    assert np.mean(out["losses"][-3:]) < out["losses"][0]


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "moonshot-v1-16b-a3b",
                                  "internvl2-2b"])
def test_launch_train_runs_the_moe_and_patch_decoders(arch):
    """launch.train takes every decoder get_model builds, unchanged: the
    MoE smoke configs and internvl2's (its first 8 positions carry no
    loss)."""
    out = train.run(arch, smoke=True, steps=3, batch=2, seq=16,
                    device="cpu")
    assert out["model"].cfg.name == get_smoke_config(arch).name
    assert np.isfinite(out["losses"] + out["grad_norms"]).all()
    assert len(out["losses"]) == 3 and int(out["opt"].step) == 3


def test_launch_train_orchestrated(capsys):
    train.main(SMOKE_ARGS + ["--steps", "3", "--orchestrate",
                             "--microbatches", "2"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("arch=llama3.2-1b-smoke")
    assert lines[-1].startswith("orchestrated: 12 TAOs in ")


def test_launch_train_resume_equals_an_uninterrupted_run(tmp_path, capsys):
    """4 steps saving every 2 == restart from the step-2 checkpoint (the
    async save) and run steps 2 and 3: the step-4 checkpoints agree leaf
    for leaf, the AdamW state included."""
    a, b = tmp_path / "a", tmp_path / "b"
    train.main(SMOKE_ARGS + ["--steps", "4", "--checkpoint-dir", str(a),
                             "--checkpoint-every", "2"])
    assert sorted(p.name for p in a.iterdir()) == ["step_00000002",
                                                   "step_00000004"]
    shutil.copytree(a / "step_00000002", b / "step_00000002")
    capsys.readouterr()
    train.main(SMOKE_ARGS + ["--steps", "4", "--checkpoint-dir", str(b),
                             "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "done: 2 steps" in out
    leaves = sorted(p.name for p in (a / "step_00000004").iterdir()
                    if p.suffix == ".npy")
    assert len(leaves) == 37
    for name in leaves:
        np.testing.assert_allclose(np.load(b / "step_00000004" / name),
                                   np.load(a / "step_00000004" / name),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


def test_orchestrated_training_takes_a_constant_lr_unclipped_and_saves_nothing(
        tmp_path):
    """The reference's fault, followed by the port (ROADMAP.md, Queue 3):
    ``--orchestrate`` updates at the constant ``--lr`` with no clipping,
    unlike the plain loop's schedule and clip, and returns before the
    checkpoint manager saves anything, in both packages."""
    from repro.launch import train as jax_train

    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    args = ["--arch", ARCH, "--smoke", "--batch", "2", "--seq", "16",
            "--steps", "2", "--orchestrate", "--microbatches", "1"]
    jax_train.main(args + ["--checkpoint-dir", str(jdir)])
    train.main(args + ["--device", "cpu", "--checkpoint-dir", str(tdir)])
    assert list(jdir.iterdir()) == [] and list(tdir.iterdir()) == []

    out = train.run(ARCH, smoke=True, steps=2, batch=2, seq=16,
                    orchestrate=True, microbatches=1, device="cpu")
    model, params = _smoke()
    opt = adamw_init(params)
    data = SyntheticLM(vocab_size=model.cfg.vocab_size, seq_len=16,
                             global_batch=2)
    for s in range(2):
        grads, _ = loss_and_grads(model, params, data.batch(s, device="cpu"))
        params, opt = adamw_update(params, grads, opt, lr=3e-4)
    for k in params:
        torch.testing.assert_close(out["params"][k], params[k], rtol=1e-6,
                                   atol=0.0)
    plain = train.run(ARCH, smoke=True, steps=2, batch=2, seq=16,
                      device="cpu")
    assert plain["lrs"][0] == pytest.approx(1.5e-4)  # the schedule's warmup
    assert not torch.equal(plain["params"]["embed.w"],
                           out["params"]["embed.w"])
