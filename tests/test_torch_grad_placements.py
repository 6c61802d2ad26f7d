"""A sharded train step hands back its state in the placements it took
(ROADMAP.md, Queue 3, fault I), on the CPU; imports no jax, so it runs on
any host of the port.

DTensor's backward leaves a grad as a partial sum over ``data`` (and over
``model`` where a body on local shards split the work,
``parallel.sharding._grad_placements``), not in its parameter's placements.
Where the clip and AdamW met those partial sums, DTensor resolved them op
by op: each grad was reduced more than once, and the step handed back its
stacked weights sharded over the layer dim and its norm weights and their
first moments as partial sums, so that a second step on the first's
outputs raised (``unbind`` along a sharded dim).  ``models.loss_and_grads``
now places each grad as its parameter, once, as ``jax.value_and_grad``
under a sharded jit does.

Held here, for the smoke config of every arch on a fake 2x2 (data, model)
world, meta DTensors, with remat off and under ``"nothing"``: each grad of
``loss_and_grads`` has its parameter's placements; after
``make_train_step`` each parameter and each moment has its input's; a
second step on the first's outputs runs and ``dryrun.StepCounter`` counts
it the same collectives by kind and the same temp as the first; and every
collective that ``clip_by_global_norm`` and ``adamw_update`` issue moves a
scalar (the global norm's sum of squares), none a grad.
"""
import dataclasses
import functools

import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import configs as tconfigs
from repro_torch import optimizer
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world
from repro_torch.models import get_model, loss_and_grads
from repro_torch.parallel.sharding import use_sharding

SHAPE = tconfigs.ShapeSpec("t", "train", 64, 4)
REMAT = {"off": {"remat": False},
         "nothing": {"remat": True, "remat_policy": "nothing"}}
ARCHS = [a for a in tconfigs.ARCH_IDS if tconfigs.cell_skip_reason(
    tconfigs.get_smoke_config(a), SHAPE) is None]
CASES = [(a, r) for a in ARCHS for r in REMAT]
# the optimizer's functions whose collectives are recorded
OPTIMIZER = ("clip_by_global_norm", "adamw_update")


def _cfg(arch: str, remat: str):
    return dataclasses.replace(tconfigs.get_smoke_config(arch),
                               **REMAT[remat])


def _mesh():
    return DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                      mesh_dim_names=("data", "model"))


def _placements(tree: dict) -> dict:
    return {k: tuple(t.placements) for k, t in tree.items()}


class _Counter(dryrun.StepCounter):
    """``StepCounter`` that also records, for each collective issued while
    ``where`` names one of ``OPTIMIZER``, (that name, its kind, the numel
    of its result)."""

    def __init__(self, args):
        super().__init__(args)
        self.where, self.optimizer = None, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        kind = getattr(func, "_overloadpacket", None)
        kind = self._kinds.get(kind)
        if self.where is not None and kind is not None:
            self.optimizer.extend((self.where, kind, t.numel())
                                  for t in dryrun._locals(out))
        return out


def _recording(name: str, counters: list):
    """``optimizer.<name>`` run with the newest of ``counters`` recording
    its collectives."""
    fn = getattr(optimizer, name)

    @functools.wraps(fn)
    def call(*args, **kwargs):
        counter = counters[-1]
        counter.where = name
        try:
            return fn(*args, **kwargs)
        finally:
            counter.where = None
    return call


@functools.lru_cache(maxsize=None)
def _grads(arch: str, remat: str) -> tuple:
    """(parameters' placements, their grads')."""
    cfg = _cfg(arch, remat)
    with fake_world(4), use_sharding(_mesh()):
        _, (params, _, batch), _ = dryrun.build_step_and_specs(cfg, SHAPE)
        with dryrun.native_all_to_all():
            grads, _ = loss_and_grads(get_model(cfg), params, batch)
        out = _placements(params), _placements(grads)
    assert not dist.is_initialized()
    return out


@functools.lru_cache(maxsize=None)
def _steps(arch: str, remat: str) -> dict:
    """Two train steps, the second on the first's outputs: the placements
    of the inputs and of each step's outputs, each step's ``_Counter``."""
    cfg = _cfg(arch, remat)
    counters = []
    with pytest.MonkeyPatch.context() as patch:
        for name in OPTIMIZER:
            patch.setattr(optimizer, name, _recording(name, counters))
        with fake_world(4), use_sharding(_mesh()):
            step, args, _ = dryrun.build_step_and_specs(cfg, SHAPE)
            out = {"in": [_placements(t) for t in
                          (args[0], args[1].mu, args[1].nu)]}
            for i in (1, 2):
                counters.append(_Counter(args))
                with dryrun.native_all_to_all(), counters[-1]:
                    params, opt, _ = step(*args)
                out[i] = [_placements(t) for t in (params, opt.mu, opt.nu)]
                args = (params, opt, args[2])
    assert not dist.is_initialized()
    out["counters"] = counters
    return out


@pytest.mark.parametrize("arch,remat", CASES)
def test_each_grad_has_its_parameters_placements(arch, remat):
    """``loss_and_grads`` places every grad, a zero grad of an unused
    parameter too, as its parameter."""
    params, grads = _grads(arch, remat)
    assert params.keys() == grads.keys()
    moved = {k: (params[k], grads[k]) for k in params
             if grads[k] != params[k]}
    assert not moved


@pytest.mark.parametrize("arch,remat", CASES)
def test_a_train_step_hands_back_its_inputs_placements(arch, remat):
    """After each of two steps, every parameter, first and second moment
    has the placements the first step took."""
    got = _steps(arch, remat)
    for i in (1, 2):
        for what, before, after in zip(("param", "mu", "nu"), got["in"],
                                       got[i]):
            moved = {k: (before[k], after[k]) for k in before
                     if after[k] != before[k]}
            assert not moved, (i, what)


@pytest.mark.parametrize("arch,remat", CASES)
def test_a_second_step_counts_the_firsts_collectives_and_temp(arch, remat):
    """The second step, on the first's outputs, issues the same
    collectives by kind, of the same bytes, and the same temp."""
    first, second = _steps(arch, remat)["counters"]
    assert second.collectives == first.collectives
    assert second.peak_bytes == first.peak_bytes
    assert first.collectives["count"] > 0


@pytest.mark.parametrize("arch,remat", CASES)
def test_the_clip_and_adamw_reduce_no_grad(arch, remat):
    """Every collective inside ``clip_by_global_norm`` and
    ``adamw_update`` moves one value, in each step: the clip's, of the
    global norm's sum of squares (one at least); AdamW, elementwise on
    grads placed as their parameters, issues none."""
    for counter in _steps(arch, remat)["counters"]:
        assert counter.optimizer
        assert {where for where, *_ in counter.optimizer} == \
            {"clip_by_global_norm"}
        assert all(numel == 1 for *_, numel in counter.optimizer), \
            counter.optimizer
