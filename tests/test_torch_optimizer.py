"""The port's optimizer and schedules against the JAX package's on the same
numpy inputs (fp32 at rtol 1e-6), and twins of tests/test_optimizer.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optimizer as jopt
from repro.configs import minicpm_2b as jminicpm
from repro_torch import optimizer as topt
from repro_torch.configs import minicpm_2b as tminicpm
from repro_torch.optimizer import (adamw_init, adamw_update,
                                   clip_by_global_norm, cosine_schedule,
                                   wsd_schedule)

RTOL = 1e-6
SHAPES = {"w": (8, 4), "b": (4,), "emb.w": (16, 3), "norm": (5,)}


def _arrays(seed: int, scale: float = 1.0) -> dict:
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _t(arrays: dict) -> dict:
    return {k: torch.from_numpy(a.copy()) for k, a in arrays.items()}


def _j(arrays: dict) -> dict:
    return {k: jnp.asarray(a) for k, a in arrays.items()}


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# ----------------------------------------------------------- against JAX --
@pytest.mark.parametrize("lr_kind", ["float", "schedule"])
def test_adamw_update_matches_jax_over_three_steps(lr_kind):
    p0 = _arrays(0)
    tp, jp = _t(p0), _j(p0)
    to, jo = adamw_init(tp), jopt.adamw_init(jp)
    tsched = cosine_schedule(1e-2, warmup_steps=1, total_steps=3)
    jsched = jopt.cosine_schedule(1e-2, warmup_steps=1, total_steps=3)
    for step in range(3):
        g = _arrays(10 + step, scale=0.1)
        tlr = 1e-2 if lr_kind == "float" else tsched(to.step + 1)
        jlr = 1e-2 if lr_kind == "float" else jsched(jo.step + 1)
        tp, to = adamw_update(tp, _t(g), to, tlr)
        jp, jo = jopt.adamw_update(jp, _j(g), jo, jlr)
    assert int(to.step) == int(jo.step) == 3
    assert to.step.dtype == torch.int32 and to.step.shape == ()
    for k in SHAPES:
        # one fp32 rounding of the update: relative to the param, not to
        # the (much smaller) moments that produced it
        _close(tp[k], jp[k], atol=1e-7)
        _close(to.mu[k], jo.mu[k], atol=1e-9)
        _close(to.nu[k], jo.nu[k], atol=1e-11)
        assert to.mu[k].dtype == torch.float32


@pytest.mark.parametrize("max_norm", [0.5, 1e9])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _arrays(3)
    tc, tn = clip_by_global_norm(_t(g), max_norm)
    jc, jn = jopt.clip_by_global_norm(_j(g), max_norm)
    _close(tn, jn)
    for k in SHAPES:
        _close(tc[k], jc[k])


def test_clip_by_global_norm_keeps_a_bf16_grad_bf16_as_jax_does():
    a = np.random.default_rng(4).standard_normal((6, 7)).astype(np.float32)
    tc, tn = clip_by_global_norm({"g": torch.from_numpy(a).bfloat16()}, 0.3)
    jc, jn = jopt.clip_by_global_norm({"g": jnp.asarray(a, jnp.bfloat16)},
                                      0.3)
    assert tc["g"].dtype == torch.bfloat16
    _close(tn, jn)
    np.testing.assert_array_equal(tc["g"].float().numpy(),
                                  np.asarray(jc["g"], np.float32))


SCHEDULES = {
    "constant": (lambda m: m.constant_lr(3e-4)),
    "cosine": (lambda m: m.cosine_schedule(3e-4, warmup_steps=2,
                                           total_steps=20)),
    "cosine-long-warmup": (lambda m: m.cosine_schedule(
        1.0, warmup_steps=10, total_steps=40, min_ratio=0.2)),
    "wsd": (lambda m: m.wsd_schedule(1e-2, 5, 20, 10)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax_at_steps_0_to_40(name):
    tf, jf = SCHEDULES[name](topt), SCHEDULES[name](jopt)
    for step in range(41):
        got = tf(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        _close(got, jf(jnp.asarray(step, jnp.int32)))
        _close(tf(step), got)


@pytest.mark.parametrize("total_steps", [40, 10_000])
def test_minicpm_train_schedule_matches_jax(total_steps):
    tf = tminicpm.train_schedule(total_steps)
    jf = jminicpm.train_schedule(total_steps)
    for step in list(range(41)) + [total_steps - 5, total_steps]:
        _close(tf(step), jf(step))


# ------------------------------------------- twins of test_optimizer.py --
def test_adamw_converges_on_quadratic():
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    opt = adamw_init(params)
    target = torch.tensor([1.0, 2.0, 3.0])
    for _ in range(300):
        g = {"w": 2 * (params["w"] - target)}
        params, opt = adamw_update(params, g, opt, lr=0.1, weight_decay=0.0)
    np.testing.assert_allclose(params["w"].numpy(), [1.0, 2.0, 3.0],
                               atol=1e-2)


def test_adamw_step_counter_and_moments_dtype():
    params = {"w": torch.zeros((4,), dtype=torch.bfloat16)}
    opt = adamw_init(params)
    assert opt.mu["w"].dtype == torch.float32
    g = {"w": torch.ones((4,), dtype=torch.bfloat16)}
    new, opt = adamw_update(params, g, opt, lr=1e-2)
    assert int(opt.step) == 1
    assert new["w"].dtype == torch.bfloat16
    assert not bool(params["w"].any())  # functional: the input is as it was


def test_clip_by_global_norm():
    g = {"a": torch.full((3,), 3.0), "b": torch.full((4,), 4.0)}
    norm = float(np.sqrt(3 * 9 + 4 * 16))
    clipped, got_norm = clip_by_global_norm(g, 1.0)
    assert float(got_norm) == pytest.approx(norm, rel=1e-5)
    total = np.sqrt(sum(float(torch.sum(torch.square(x)))
                        for x in clipped.values()))
    assert total == pytest.approx(1.0, rel=1e-4)
    # under the cap: untouched
    same, _ = clip_by_global_norm(g, 1e9)
    np.testing.assert_allclose(same["a"].numpy(), g["a"].numpy())


def test_cosine_schedule_shape():
    f = cosine_schedule(1.0, warmup_steps=10, total_steps=100)
    assert float(f(0)) == 0.0
    assert float(f(10)) == pytest.approx(1.0, abs=1e-6)
    assert float(f(55)) < 1.0
    assert float(f(100)) == pytest.approx(0.1, abs=1e-6)


def test_wsd_schedule_shape():
    f = wsd_schedule(1.0, warmup_steps=10, stable_steps=80, decay_steps=10)
    assert float(f(5)) == pytest.approx(0.5)
    # stable plateau
    for s in (10, 40, 89):
        assert float(f(s)) == pytest.approx(1.0)
    # decay tail
    assert float(f(95)) < 1.0
    assert float(f(100)) == pytest.approx(0.01, abs=1e-6)
