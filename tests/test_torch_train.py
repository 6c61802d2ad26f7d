"""The port's training path against the JAX package's, on the CPU:
``make_train_step`` on JAX's weights (fp32 activations at rtol 1e-4 / atol
1e-5, the models' bf16 at 3e-2 relative Frobenius: the bounds of
tests/test_torch_autograd.py), through the kernels' Functions and through
the plain versions; the training DAG and its simulation; the threaded
training run against sequential training; and ``launch.train``'s entry
point, plain, orchestrated and resumed."""
import shutil
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from repro.optimizer import adamw_init as jax_adamw_init
from repro.optimizer import cosine_schedule as jax_cosine_schedule
from repro_torch.configs import get_smoke_config
from repro_torch.core import hikey960, make_policy
from repro_torch.data import SyntheticLM
from repro_torch.launch import train
from repro_torch.models import (get_model, loss_and_grads, make_train_step,
                                transformer)
from repro_torch.models.convert import params_from_numpy
from repro_torch.optimizer import adamw_init, adamw_update, cosine_schedule
from repro_torch.train_orchestrator import (GradAccumulator,
                                            build_training_dag,
                                            run_training_threaded,
                                            simulate_training)
from test_torch_autograd import (_as_if_on_the_card, _Float32Jnp,  # noqa: F401
                                 launches)

ARCH = "llama3.2-1b"
STEPS = 3
_JAX_RUNS: dict = {}  # activations -> JAX's trajectory (deterministic)


def _batches(vocab: int) -> list:
    rng = np.random.default_rng(21)
    out = []
    for _ in range(STEPS):
        t = rng.integers(0, vocab, (2, 17)).astype(np.int32)
        out.append({"tokens": t[:, :-1], "targets": t[:, 1:]})
    return out


def _jax_run(activations: str) -> dict:
    """JAX's make_train_step for STEPS steps on the smoke llama3.2-1b."""
    if activations not in _JAX_RUNS:
        jm = jax_get_model(jax_smoke_config(ARCH))
        params = jm.init(jax.random.PRNGKey(0))
        init = {k: np.asarray(v) for k, v in params.items()}
        opt = jax_adamw_init(params)
        step = jax.jit(jax_make_train_step(jm, jax_cosine_schedule(
            1e-3, warmup_steps=2, total_steps=STEPS)))
        metrics = []
        for b in _batches(jm.cfg.vocab_size):
            params, opt, m = step(params, opt,
                                  {k: jnp.asarray(v) for k, v in b.items()})
            metrics.append({k: float(m[k])
                            for k in ("loss", "grad_norm", "lr")})
        _JAX_RUNS[activations] = {
            "init": init, "metrics": metrics,
            "params": {k: np.asarray(v) for k, v in params.items()},
            "mu": {k: np.asarray(v) for k, v in opt.mu.items()},
            "nu": {k: np.asarray(v) for k, v in opt.nu.items()},
            "step": int(opt.step)}
    return _JAX_RUNS[activations]


def _rel(got: torch.Tensor, want: np.ndarray) -> float:
    return float(np.linalg.norm(got.float().numpy() - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("activations", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["functions", "plain"])
def test_make_train_step_matches_jax(launches, monkeypatch, route,
                                     activations):
    if activations == "float32":
        monkeypatch.setattr(jax_transformer, "jnp", _Float32Jnp())
        monkeypatch.setattr(transformer, "ACT_DTYPE", torch.float32)
    want = _jax_run(activations)
    if route == "functions":
        _as_if_on_the_card(monkeypatch)
    model = get_model(get_smoke_config(ARCH))
    params = params_from_numpy(want["init"], "cpu")
    opt = adamw_init(params)
    step = make_train_step(model, cosine_schedule(1e-3, warmup_steps=2,
                                                  total_steps=STEPS))
    for b, jm in zip(_batches(model.cfg.vocab_size), want["metrics"]):
        params, opt, m = step(params, opt, {k: torch.from_numpy(v)
                                            for k, v in b.items()})
        assert set(m) == {"loss", "ppl_proxy", "grad_norm", "lr"}
        assert not any(v.requires_grad for v in m.values())
        rtol = 1e-4 if activations == "float32" else 3e-2
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(m[k].item(), jm[k], rtol=rtol,
                                       err_msg=k)
    layers = model.cfg.n_layers
    assert dict(launches) == ({"rmsnorm": STEPS * (2 * layers + 1),
                               "flash_attention": STEPS * layers}
                              if route == "functions" else {})
    assert int(opt.step) == want["step"] == STEPS
    for tree, ref in ((params, want["params"]), (opt.mu, want["mu"]),
                      (opt.nu, want["nu"])):
        assert set(tree) == set(ref)
        for name, got in tree.items():
            assert got.dtype == torch.float32
            if activations == "float32":
                np.testing.assert_allclose(got.numpy(), ref[name], rtol=1e-4,
                                           atol=1e-5, err_msg=name)
            else:
                assert _rel(got, ref[name]) <= 3e-2, name


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
