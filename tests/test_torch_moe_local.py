"""Fault J (ROADMAP.md, Queue 3): under a mesh the MoE's expert
down-projection and its combine run on each rank's local shards, and each
token's output is reduced once, on the CPU.

``layers.moe_ffn`` constrains the gathered tokens and the experts' hidden
as the reference does and used to leave the down-projection ``einsum(
"becf,efm->becm")``, the combine's ``gather`` over the E * C slots and the
sum over k to DTensor, whose releases place them each its own way: one
reduce-scattered the (B, E * C, M) product, another gathered it in the
combine.  All three are linear in the hidden, so each rank now runs them
on its own slice of F (``act_ff`` took ``model``: experts that ``model``
does not divide) or of E (``act_expert`` took it), and hands on a
``Partial`` sum of the (B, S, M) token output, reduced once.

Two cases of the smoke mixtral-8x22b on a (data=2, model=2) mesh: ``ep``,
its 4 experts split over ``model``, and ``ff-split``, 3 experts that
``model`` does not divide, so that F is split.  For each:

- ``moe_ffn`` on 4 gloo ranks (one module-scoped spawn, ``FileStore`` in a
  temporary directory) against the unsharded one on the same numpy inputs
  from a seed, in fp32, with a capacity that drops assignments: the output
  and the grads of x, the router and the three expert weights, each within
  1e-5 of the unsharded tensor's largest magnitude;
- on meta DTensors of a fake 2x2 world, the train, prefill and decode
  steps: no collective moves a tensor of E * C slot rows, forward or
  backward, and each call of ``moe_ffn`` reduces one (B, S, M) tensor,
  as ``dryrun.StepCounter`` counts the collectives;
- the world's matmul FLOPs of a train step equal the unsharded step's, and
  a device's equal those the program DTensor chose used to count.

The collective checks fail on the tree before the repair.  This file
imports no JAX: it runs on a host that has torch alone.
"""
import contextlib
import dataclasses
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh
from torch.utils._pytree import tree_leaves

from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world
from repro_torch.models import layers, transformer
from repro_torch.parallel.sharding import place, use_sharding

ARCH, WORLD, B = "mixtral-8x22b", 4, 4
# case -> config changes
CASES = {"ep": {}, "ff-split": {"n_experts": 3}}
# moe_ffn alone: tokens a row, and a capacity short of the 2 * 24 / E
# assignments an expert takes on average, so that some are dropped
MOE_S, MOE_CAPACITY = 24, 8
# each argument's logical names, as the decoder lays them out
MOE_ARGS = {"x": ("batch", "seq", "act_embed"), "router": ("embed", None),
            "we1": ("expert", "embed", "ff"),
            "we3": ("expert", "embed", "ff"),
            "we2": ("expert", "ff", "embed")}
# how a mesh dim that splits we2's M runs the down-projection
# (``layers._fsdp_layout``), each forced on the gloo ranks: F can split
# over data only where model does not split it already (ep)
LAYOUTS = {"ep": ("gather_w", "gather_h", "split_f"),
           "ff-split": ("gather_w", "gather_h")}
RUNS = [f"{case}:{layout}" for case in CASES for layout in LAYOUTS[case]]
# the steps on the fake world: kind -> sequence length (the prefill past
# the 32-token window)
STEPS = {"train": 64, "prefill": 40, "decode": 64}
# a device's matmul FLOPs of the train step on the 2x2 world, as the
# program DTensor chose counted them before the repair
PARENT_TRAIN_FLOPS_PER_DEVICE = {"ep": 81068032, "ff-split": 83394560}
REDUCTIONS = ("all-reduce", "reduce-scatter")
RANKS_TIMEOUT_S = 300


def _config(case: str):
    return dataclasses.replace(tconfigs.get_smoke_config(ARCH),
                               **CASES[case])


def _moe_inputs(case: str) -> dict:
    """moe_ffn's arguments and the output's cotangent, from a seed."""
    cfg = _config(case)
    rng = np.random.default_rng(7)
    M, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts

    def normal(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return {"x": normal(B, MOE_S, M), "router": normal(M, E, scale=0.3),
            "we1": normal(E, M, F, scale=M ** -0.5),
            "we3": normal(E, M, F, scale=M ** -0.5),
            "we2": normal(E, F, M, scale=F ** -0.5),
            "gy": normal(B, MOE_S, M)}


def _moe(case: str, mesh=None, layout: str | None = None) -> dict:
    """moe_ffn of ``case`` under ``mesh`` (None: unsharded), with every
    mesh dim that splits we2's M taking ``layout``: y and the grads of its
    five arguments of the loss sum(y * gy), each whole; under a mesh y's
    placements and local shape, and the layouts taken."""
    cfg = _config(case)
    arrays = _moe_inputs(case)
    taken = []

    def forced(*args):
        taken.append(layout)
        return layout

    with use_sharding(mesh), pytest.MonkeyPatch.context() as mp_:
        mp_.setattr(layers, "_fsdp_layout", forced)
        ins = {k: place(torch.from_numpy(arrays[k]), names).detach()
               .requires_grad_() for k, names in MOE_ARGS.items()}
        gy = place(torch.from_numpy(arrays["gy"]), MOE_ARGS["x"])
        y = layers.moe_ffn(*ins.values(), n_experts=cfg.n_experts,
                           top_k=cfg.experts_per_token,
                           capacity=MOE_CAPACITY)
        (y * gy).sum().backward()
    out = {"y": _np(y), **{f"grad.{k}": _np(t.grad)
                           for k, t in ins.items()}}
    if mesh is not None:
        out["pls:y"] = np.asarray(str(tuple(y.placements)))
        out["shape:y"] = np.asarray(y.to_local().shape)
        out["layouts"] = np.asarray(taken)
    return out


def _np(t: torch.Tensor) -> np.ndarray:
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    return t.detach().numpy()


def _rank_main(rank: int, tmp: str) -> None:
    """One of the 4 gloo ranks: each case's ``_moe`` on the (data, model)
    mesh, written to ``rank{rank}_{case}.npz``."""
    torch.set_num_threads(1)
    tmp = Path(tmp)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp / "store"), WORLD), rank=rank, world_size=WORLD)
    try:
        mesh = DeviceMesh("cpu", torch.arange(WORLD).reshape(2, 2),
                          mesh_dim_names=("data", "model"))
        for run in RUNS:
            case, layout = run.split(":")
            np.savez(tmp / f"rank{rank}_{run}.npz",
                     **_moe(case, mesh, layout))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory) -> dict:
    """case:layout -> {"sharded": rank 0's outputs, "port": the unsharded
    ones}."""
    tmp = tmp_path_factory.mktemp("moe4")
    ranks = mp.start_processes(_rank_main, args=(str(tmp),), nprocs=WORLD,
                               join=False, start_method="spawn")
    port = {case: _moe(case) for case in CASES}
    out = {run: {"port": port[run.split(":")[0]]} for run in RUNS}
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    while not ranks.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ranks.processes:
                p.kill()
            raise TimeoutError(f"the {WORLD} ranks ran past "
                               f"{RANKS_TIMEOUT_S} s")
    for run in RUNS:
        got = [dict(np.load(tmp / f"rank{r}_{run}.npz"))
               for r in range(WORLD)]
        for other in got[1:]:   # every rank gathers the same full tensors
            assert all(np.array_equal(other[k], got[0][k])
                       for k in got[0] if not k.startswith("shape:"))
        out[run]["sharded"] = got[0]
    return out


@pytest.mark.parametrize("run", RUNS)
def test_moe_ffn_on_the_mesh_matches_unsharded(runs, run):
    """y and the grads of x, the router, we1, we3 and we2 on the mesh, with
    ``data`` (which splits we2's M) taking each layout, against the
    unsharded ``moe_ffn``, in fp32, each within 1e-5 of the unsharded
    tensor's largest magnitude; y comes back laid out as x, the batch
    split over data, whole over model."""
    case, layout = run.split(":")
    got, want = runs[run]["sharded"], runs[run]["port"]
    assert list(got["layouts"]) == [layout]
    names = ["y", *(f"grad.{k}" for k in MOE_ARGS)]
    for k in names:
        assert np.abs(want[k]).max() > 0, k
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-5 * np.abs(want[k]).max(),
                                   err_msg=k)
    assert str(got["pls:y"]) == "(Shard(dim=0), Replicate())"
    assert list(got["shape:y"]) == [B // 2, MOE_S, _config(case).d_model]


def test_the_moe_inputs_drop_assignments():
    """The capacity drops assignments in both cases, and the ``ep`` case's
    experts split over model while ``ff-split``'s do not."""
    for case in CASES:
        cfg = _config(case)
        ids = torch.topk(torch.einsum("bsm,me->bse", *(torch.from_numpy(
            _moe_inputs(case)[k]) for k in ("x", "router"))),
            cfg.experts_per_token, dim=-1).indices
        load = torch.bincount(ids.flatten(1)[0], minlength=cfg.n_experts)
        assert int(load.max()) > MOE_CAPACITY, (case, load)
    assert _config("ep").n_experts % 2 == 0
    assert _config("ff-split").n_experts % 2 == 1


@pytest.mark.parametrize("cell,want", [
    # a device's local shards, bf16, on 16x16 (data 16): mixtral-8x22b's
    # train_4k hidden (16, 8, 1280, 1024) and we2 (8, 1024, 384)
    (dict(h=16 * 8 * 1280 * 1024 * 2, w=8 * 1024 * 384 * 2,
          y=16 * 4096 * 6144 * 2, rows_split=True, f_free=False),
     "gather_w"),
    # its decode_32k step: hidden (8, 8, 8, 1024), F split over model
    (dict(h=8 * 8 * 8 * 1024 * 2, w=8 * 1024 * 384 * 2, y=8 * 6144 * 2,
          rows_split=True, f_free=False), "gather_h"),
    # moonshot-v1-16b-a3b's decode_32k: hidden (8, 4, 8, 1408), we2
    # (4, 1408, 128), F whole on each model rank
    (dict(h=8 * 4 * 8 * 1408 * 2, w=4 * 1408 * 128 * 2, y=8 * 2048 * 2,
          rows_split=True, f_free=True), "split_f"),
    # and its prefill_32k: hidden (2, 4, 3840, 1408)
    (dict(h=2 * 4 * 3840 * 1408 * 2, w=4 * 1408 * 128 * 2,
          y=2 * 32768 * 2048 * 2, rows_split=True, f_free=True),
     "gather_w"),
    # a batch of one, whole on every data rank (long_500k)
    (dict(h=1 * 8 * 8 * 1024 * 2, w=8 * 1024 * 384 * 2, y=6144 * 2,
          rows_split=False, f_free=False), "gather_h")],
    ids=["mixtral-train", "mixtral-decode", "moonshot-decode",
         "moonshot-prefill", "batch-of-one"])
def test_a_layout_moves_the_fewest_bytes(cell, want):
    """``_fsdp_layout`` gathers we2 where the hidden is large (training,
    prefill) and moves the hidden in a decode step: its rows where F is
    split over model, F over data where it is not."""
    assert layers._fsdp_layout(16, **cell) == want


# ------------------------------------------------ meta 2x2: collectives
@pytest.fixture
def mesh2x2():
    """A (data=2, model=2) mesh over a fake world of 4 ranks, destroyed
    after the test."""
    with fake_world(4):
        yield DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                         mesh_dim_names=("data", "model"))
    assert not dist.is_initialized()


class _Sites(dryrun.StepCounter):
    """The dry run's counter, which also keeps each collective's kind, the
    redistribution that issued it (its number and the global shape of the
    DTensor it moves; None where none was under way), its local tensors'
    shapes and the call of ``moe_ffn`` open at the time (None outside
    one): ``seen``."""

    def __init__(self, args=()):
        super().__init__(args)
        self.seen = []
        self.specs = []      # redistributions under way, innermost last
        self.n_redistributions = 0
        self.moe_call = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        kind = self._kinds.get(getattr(func, "_overloadpacket", None))
        if kind is not None and out is not NotImplemented:
            self.seen.append((kind, self.specs[-1] if self.specs else None,
                              [tuple(t.shape) for t in
                               tree_leaves((args, out))
                               if isinstance(t, torch.Tensor)],
                              self.moe_call))
        return out


@contextlib.contextmanager
def _watching(sites: _Sites):
    """While open, DTensor's redistributions push (their number, the global
    shape of the DTensor they move) onto ``sites.specs``, and each call of
    the decoder's
    ``moe_ffn`` is ``sites.moe_call`` while it runs.  Yields {call: whether
    it returned}: a call that remat's recompute stops once it has what the
    backward needs does not."""
    import torch.distributed.tensor._dispatch as dispatch
    import torch.distributed.tensor._redistribute as redistribute

    orig, moe = redistribute.redistribute_local_tensor, transformer.moe_ffn
    calls = {}

    def named(local, current_spec, *args, **kwargs):
        sites.n_redistributions += 1
        sites.specs.append((sites.n_redistributions,
                            tuple(current_spec.shape)))
        try:
            return orig(local, current_spec, *args, **kwargs)
        finally:
            sites.specs.pop()

    def counted(*args, **kwargs):
        outer, sites.moe_call = sites.moe_call, len(calls)
        calls[sites.moe_call] = False
        try:
            out = moe(*args, **kwargs)
            calls[sites.moe_call] = True
            return out
        finally:
            sites.moe_call = outer

    with pytest.MonkeyPatch.context() as mp_:
        for mod in (dispatch, redistribute):
            mp_.setattr(mod, "redistribute_local_tensor", named)
        mp_.setattr(transformer, "moe_ffn", counted)
        yield calls


@pytest.mark.parametrize("kind", sorted(STEPS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_ffn_moves_no_slot_and_reduces_each_output_once(mesh2x2, case,
                                                            kind):
    """The step on meta DTensors of the 2x2 world (a train step's backward
    and remat's recompute in it too): while a call of ``moe_ffn`` runs, no
    collective moves the experts' output, a DTensor of E * C slot rows or
    of (E, C) dims and M columns, nor (where no redistribution issued it) a
    local tensor of E * C rows, whole or split over model (a decode step
    may move the hidden, (B, E, C, F), where that moves fewer bytes than
    we2: ``layers._fsdp_layout``); and each call that returns reduces one
    DTensor, the (B, S, M) token output, in one redistribution (one that
    remat's recompute stops early at most that one)."""
    cfg = _config(case)
    seq = STEPS[kind]
    shape = tconfigs.ShapeSpec(f"{case}-{kind}", kind, seq, B)
    c = cfg.moe_capacity(1 if kind == "decode" else seq)
    ec = cfg.n_experts * c
    tokens = (B, 1 if kind == "decode" else seq, cfg.d_model)
    with use_sharding(mesh2x2):
        step, args, _ = dryrun.build_step_and_specs(cfg, shape)
        sites = _Sites(args)
        with _watching(sites) as calls, sites:
            step(*args)
    assert sum(calls.values()) >= cfg.n_layers
    in_moe = [(k, r, loc, n) for k, r, loc, n in sites.seen if n is not None]
    slots = [(k, r, loc) for k, r, loc, _ in in_moe if
             (r is not None and r[1][-1] == cfg.d_model and (
                 (len(r[1]) == 3 and r[1][1] == ec) or
                 tuple(r[1][1:3]) == (cfg.n_experts, c)))
             or (r is None and any(len(t) >= 3 and t[1] in (ec, ec // 2)
                                   for t in loc))]
    assert not slots, slots[:5]
    for call, returned in calls.items():
        got = {r for k, r, _, n in in_moe if n == call and k in REDUCTIONS}
        assert len(got) == 1 if returned else len(got) <= 1, \
            (call, [s for s in in_moe if s[3] == call])
        assert all(r is not None and r[1] == tokens for r in got), got


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_train_step_keeps_its_flops(mesh2x2, case):
    """The world's matmul FLOPs of the smoke train step on the 2x2 world
    equal the unsharded step's, and a device's equal what they were before
    the down-projection moved into a body on local shards."""
    cfg = _config(case)
    shape = tconfigs.ShapeSpec(case, "train", STEPS["train"], B)
    got = dryrun.run_cell(cfg, shape, mesh2x2)
    want = dryrun.run_cell(cfg, shape, None)
    assert got["matmul_flops"] == want["matmul_flops"]
    assert got["matmul_flops_per_device"] == \
        PARENT_TRAIN_FLOPS_PER_DEVICE[case]
