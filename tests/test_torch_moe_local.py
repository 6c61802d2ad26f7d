"""Faults J and K (ROADMAP.md, Queue 3): under a mesh the MoE's dispatch,
its expert up-projections, the down-projection and the combine run on each
rank's local shards, and each token's output and each token's grad are
reduced once, on the CPU.

``layers.moe_ffn`` constrains the gathered tokens and the experts' hidden
as the reference does and used to leave the down-projection ``einsum(
"becf,efm->becm")``, the combine's ``gather`` over the E * C slots and the
sum over k to DTensor, whose releases place them each its own way: one
reduce-scattered the (B, E * C, M) product, another gathered it in the
combine (fault J).  It also left the dispatch (``xz.gather`` into (B,
E * C, M)) and the two up-projections to DTensor, whose backward
all-reduced the gathered tokens' cotangent and zeroed the whole batch's
(B, S + 1, M) on each device (fault K).  Each rank now gathers its own
experts' slots from its own rows and makes its slice of the hidden
(``layers._local_dispatch_and_up``), and runs the down-projection and the
combine on its own slice of F (``act_ff`` took ``model``: experts that
``model`` does not divide) or of E (``act_expert`` took it), handing on a
``Partial`` sum of the (B, S, M) token output, reduced once; x's grad is
a ``Partial`` sum reduced once the same way.

Three cases on a (data=2, model=2) mesh: the smoke mixtral-8x22b as it is
(``ep``, its 4 experts split over ``model``) and with 3 experts, which
``model`` does not divide, so that F is split (``ff-split``), and the
smoke moonshot-v1-16b-a3b (``moonshot``, 8 experts split over ``model``).
For each:

- ``moe_ffn`` on 4 gloo ranks (one module-scoped spawn, ``FileStore`` in a
  temporary directory) against the unsharded one on the same numpy inputs
  from a seed, in fp32, with a capacity that drops assignments, the up-
  and down-projections' layouts over ``data`` (which splits the weights'
  M) each forced: the output and the grads of x, the router and the three
  expert weights, each within 1e-5 of the unsharded tensor's largest
  magnitude;
- on meta DTensors of a fake 2x2 world, the train, prefill and decode
  steps: no collective moves a tensor of E * C slot rows, forward or
  backward, and each call of ``moe_ffn`` reduces one (B, S, M) tensor
  (and, where a decode step splits the weights' M, its two partial
  products), as ``dryrun.StepCounter`` counts the collectives; in a train
  step's backward each call reduces x's (B, S, M) grad once and nothing
  else; no op of a train step makes a tensor of the whole batch's (B,
  S + 1, M); a decode step's up-projections issue only their layout's
  collectives;
- the world's matmul FLOPs of a train step equal the unsharded step's, and
  a device's equal those the program DTensor chose used to count.

The collective and memory checks fail on the tree before each repair.
This file imports no JAX: it runs on a host that has torch alone.
"""
import collections
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

WORLD, B = 4, 4
# case -> (arch, config changes)
CASES = {"ep": ("mixtral-8x22b", {}),
         "ff-split": ("mixtral-8x22b", {"n_experts": 3}),
         "moonshot": ("moonshot-v1-16b-a3b", {})}
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
# over data only where model does not split it already (ep, moonshot)
LAYOUTS = {"ep": ("gather_w", "gather_h", "split_f"),
           "ff-split": ("gather_w", "gather_h"),
           "moonshot": ("gather_w", "gather_h", "split_f")}
# and how one that splits we1's and we3's M runs the up-projections
# (``layers._fsdp_up_layout``)
UP_LAYOUTS = ("gather_w", "split_m")
# case:down (the up-projections' layout taken by bytes) and
# case:down:up, each forced
RUNS = [f"{case}:{layout}" for case in ("ep", "ff-split")
        for layout in LAYOUTS[case]] + \
    [f"{case}:{layout}:{up}" for case in CASES for layout in LAYOUTS[case]
     for up in UP_LAYOUTS]
# the steps on the fake world: kind -> sequence length (the prefill past
# the 32-token window)
STEPS = {"train": 64, "prefill": 40, "decode": 64}
# a device's matmul FLOPs of the train step on the 2x2 world, as the
# program DTensor chose counted them before the repair
PARENT_TRAIN_FLOPS_PER_DEVICE = {"ep": 81068032, "ff-split": 83394560,
                                 "moonshot": 57278464}
REDUCTIONS = ("all-reduce", "reduce-scatter")
RANKS_TIMEOUT_S = 300


def _config(case: str):
    arch, changes = CASES[case]
    return dataclasses.replace(tconfigs.get_smoke_config(arch), **changes)


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


def _moe(case: str, mesh=None, layout: str | None = None,
         up: str | None = None) -> dict:
    """moe_ffn of ``case`` under ``mesh`` (None: unsharded), with every
    mesh dim that splits we2's M taking ``layout`` and (unless None: the
    fewest bytes) every one that splits we1's and we3's M taking ``up``:
    y and the grads of its five arguments of the loss sum(y * gy), each
    whole; under a mesh y's placements and local shape, and the layouts
    taken."""
    cfg = _config(case)
    arrays = _moe_inputs(case)
    taken, taken_up = [], []
    by_bytes = layers._fsdp_up_layout

    def forced(*args):
        taken.append(layout)
        return layout

    def forced_up(*args):
        taken_up.append(up or by_bytes(*args))
        return taken_up[-1]

    with use_sharding(mesh), pytest.MonkeyPatch.context() as mp_:
        mp_.setattr(layers, "_fsdp_layout", forced)
        mp_.setattr(layers, "_fsdp_up_layout", forced_up)
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
        out["up_layouts"] = np.asarray(taken_up)
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
            case, layout, *up = run.split(":")
            np.savez(tmp / f"rank{rank}_{run}.npz",
                     **_moe(case, mesh, layout, *up))
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
    ``data`` (which splits the expert weights' M) taking each layout of
    the down-projection and (where the run names one) of the
    up-projections, against the unsharded ``moe_ffn``, in fp32, each
    within 1e-5 of the unsharded tensor's largest magnitude; y comes back
    laid out as x, the batch split over data, whole over model."""
    case, layout, *up = run.split(":")
    got, want = runs[run]["sharded"], runs[run]["port"]
    assert list(got["layouts"]) == [layout]
    assert len(got["up_layouts"]) == 1
    assert list(got["up_layouts"]) == up or not up
    names = ["y", *(f"grad.{k}" for k in MOE_ARGS)]
    for k in names:
        assert np.abs(want[k]).max() > 0, k
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-5 * np.abs(want[k]).max(),
                                   err_msg=k)
    assert str(got["pls:y"]) == "(Shard(dim=0), Replicate())"
    assert list(got["shape:y"]) == [B // 2, MOE_S, _config(case).d_model]


def test_the_moe_inputs_drop_assignments():
    """The capacity drops assignments in every case, and the ``ep`` and
    ``moonshot`` cases' experts split over model while ``ff-split``'s do
    not."""
    for case in CASES:
        cfg = _config(case)
        ids = torch.topk(torch.einsum("bsm,me->bse", *(torch.from_numpy(
            _moe_inputs(case)[k]) for k in ("x", "router"))),
            cfg.experts_per_token, dim=-1).indices
        load = torch.bincount(ids.flatten(1)[0], minlength=cfg.n_experts)
        assert int(load.max()) > MOE_CAPACITY, (case, load)
    assert _config("ep").n_experts % 2 == 0
    assert _config("moonshot").n_experts % 2 == 0
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


@pytest.mark.parametrize("cell,want", [
    # a device's local shards, bf16 (ids int64), on 16x16 (data 16):
    # mixtral-8x22b's train_4k tokens (16, 4096, 6144), slot ids (16,
    # 8 * 1280), we1 (8, 384, 1024) and hidden (16, 8, 1280, 1024)
    (dict(x=16 * 4096 * 6144 * 2, t=16 * 10240 * 8, w=8 * 384 * 1024 * 2,
          h=16 * 8 * 1280 * 1024 * 2, rows_split=True), "gather_w"),
    # its decode_32k step: tokens (8, 1, 6144), ids (8, 64), hidden (8, 8,
    # 8, 1024)
    (dict(x=8 * 6144 * 2, t=8 * 64 * 8, w=8 * 384 * 1024 * 2,
          h=8 * 8 * 8 * 1024 * 2, rows_split=True), "split_m"),
    # moonshot-v1-16b-a3b's decode_32k: ids (8, 64 * 8), we1 (4, 128,
    # 1408), hidden (8, 4, 8, 1408)
    (dict(x=8 * 2048 * 2, t=8 * 512 * 8, w=4 * 128 * 1408 * 2,
          h=8 * 4 * 8 * 1408 * 2, rows_split=True), "split_m"),
    # and its prefill_32k: tokens (2, 32768, 2048), hidden (2, 4, 3840,
    # 1408)
    (dict(x=2 * 32768 * 2048 * 2, t=2 * 30720 * 8, w=4 * 128 * 1408 * 2,
          h=2 * 4 * 3840 * 1408 * 2, rows_split=True), "gather_w"),
    # a batch of one, whole on every data rank (long_500k)
    (dict(x=6144 * 2, t=64 * 8, w=8 * 384 * 1024 * 2,
          h=1 * 8 * 8 * 1024 * 2, rows_split=False), "split_m")],
    ids=["mixtral-train", "mixtral-decode", "moonshot-decode",
         "moonshot-prefill", "batch-of-one"])
def test_an_up_layout_moves_the_fewest_bytes(cell, want):
    """``_fsdp_up_layout`` gathers we1 and we3 where the tokens are many
    (training, prefill) and splits M in a decode step, whose partial
    products are small."""
    assert layers._fsdp_up_layout(16, **cell) == want


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
    redistribution that issued it (its number, the global shape of the
    DTensor it moves and its placements before and after; None where none
    was under way), its local tensors' shapes, the call of ``moe_ffn`` open
    at the time (None outside one), the call whose backward runs (None
    outside one) and whether ``_local_dispatch_and_up`` runs: ``seen``, a
    ``_Seen`` each.  ``ups`` holds each call's up-projection layouts
    (``layers._fsdp_up_layout``'s choices)."""

    def __init__(self, args=()):
        super().__init__(args)
        self.seen = []
        self.specs = []      # redistributions under way, innermost last
        self.n_redistributions = 0
        self.moe_call = self.moe_backward = None
        self.up = False
        self.ups = collections.defaultdict(list)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        kind = self._kinds.get(getattr(func, "_overloadpacket", None))
        if kind is not None and out is not NotImplemented:
            self.seen.append(_Seen(
                kind, self.specs[-1] if self.specs else None,
                [tuple(t.shape) for t in tree_leaves((args, out))
                 if isinstance(t, torch.Tensor)],
                self.moe_call, self.moe_backward, self.up))
        return out


@dataclasses.dataclass
class _Seen:
    kind: str
    spec: tuple | None      # (number, global shape, from, to)
    local: list
    call: int | None
    backward: int | None
    up: bool


def _pls(pls) -> str:
    return ",".join("P" if p.is_partial() else "R" if p.is_replicate()
                    else f"S{p.dim}" for p in pls)


@contextlib.contextmanager
def _watching(sites: _Sites):
    """While open, DTensor's redistributions push (their number, the global
    shape of the DTensor they move, its placements before and after) onto
    ``sites.specs``; each call of the decoder's ``moe_ffn`` is
    ``sites.moe_call`` while it runs, and where it records a graph,
    ``sites.moe_backward`` from the moment its output's grad is ready to
    the moment its input's is (its backward: the engine runs the nodes it
    made, the latest, first); ``sites.up`` is set while
    ``layers._local_dispatch_and_up`` runs, and each choice of
    ``layers._fsdp_up_layout`` is kept under its call.  Yields {call:
    whether it returned}: a call that remat's recompute stops once it has
    what the backward needs does not."""
    import torch.distributed.tensor._dispatch as dispatch
    import torch.distributed.tensor._redistribute as redistribute

    orig, moe = redistribute.redistribute_local_tensor, transformer.moe_ffn
    # (absent before the dispatch moved onto local shards: nothing to mark)
    up = getattr(layers, "_local_dispatch_and_up", None)
    up_layout = getattr(layers, "_fsdp_up_layout", None)
    calls = {}

    def named(local, current_spec, target_spec, *args, **kwargs):
        sites.n_redistributions += 1
        sites.specs.append((sites.n_redistributions,
                            tuple(current_spec.shape),
                            _pls(current_spec.placements),
                            _pls(target_spec.placements)))
        try:
            return orig(local, current_spec, target_spec, *args, **kwargs)
        finally:
            sites.specs.pop()

    def counted(*args, **kwargs):
        outer, sites.moe_call = sites.moe_call, len(calls)
        call = sites.moe_call
        calls[call] = False
        try:
            out = moe(*args, **kwargs)
            calls[call] = True
        finally:
            sites.moe_call = outer
        if out.requires_grad:
            def opened(g):
                sites.moe_backward = call

            def closed(g):
                sites.moe_backward = None
            out.register_hook(opened)
            args[0].register_hook(closed)
        return out

    def in_up(*args, **kwargs):
        sites.up = True
        try:
            return up(*args, **kwargs)
        finally:
            sites.up = False

    def chosen(*args, **kwargs):
        out = up_layout(*args, **kwargs)
        sites.ups[sites.moe_call].append(out)
        return out

    with pytest.MonkeyPatch.context() as mp_:
        for mod in (dispatch, redistribute):
            mp_.setattr(mod, "redistribute_local_tensor", named)
        mp_.setattr(transformer, "moe_ffn", counted)
        if up is not None:
            mp_.setattr(layers, "_local_dispatch_and_up", in_up)
            mp_.setattr(layers, "_fsdp_up_layout", chosen)
        yield calls


def _step(cfg, kind: str, mesh, name: str) -> tuple:
    """``kind``'s smoke step of ``cfg`` on meta DTensors of ``mesh``, run
    once under ``_watching`` and the dry run's own all-to-all: (sites,
    calls, the step's slot count E * C and its token shape (B, S, M))."""
    seq = STEPS[kind]
    shape = tconfigs.ShapeSpec(name, kind, seq, B)
    c = cfg.moe_capacity(1 if kind == "decode" else seq)
    with use_sharding(mesh):
        step, args, _ = dryrun.build_step_and_specs(cfg, shape)
        sites = _Sites(args)
        with _watching(sites) as calls, dryrun.native_all_to_all(), sites:
            step(*args)
    return sites, calls, c, (B, 1 if kind == "decode" else seq,
                             cfg.d_model)


def _moves_slots(seen: _Seen, cfg, c: int) -> bool:
    """Whether a collective moves the experts' tokens or output: a DTensor
    of E * C slot rows or of (E, C) dims, and M columns; or, where no
    redistribution issued it, a local tensor of E * C (or E * C / 2) rows."""
    ec = cfg.n_experts * c
    if seen.spec is not None:
        shape = seen.spec[1]
        return len(shape) >= 3 and shape[-1] == cfg.d_model and (
            (len(shape) == 3 and shape[1] == ec)
            or tuple(shape[1:3]) == (cfg.n_experts, c))
    return any(len(t) >= 3 and t[1] in (ec, ec // 2) for t in seen.local)


@pytest.mark.parametrize("kind", sorted(STEPS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_ffn_moves_no_slot_and_reduces_each_output_once(mesh2x2, case,
                                                            kind):
    """The step on meta DTensors of the 2x2 world (a train step's backward
    and remat's recompute in it too): no collective of the step, forward
    or backward, moves the experts' tokens or output, a DTensor of E * C
    slot rows or of (E, C) dims and M columns, nor (where no
    redistribution issued it) a local tensor of E * C rows, whole or split
    over model (a decode step may move the hidden, (B, E, C, F), where that
    moves fewer bytes than the weights: ``layers._fsdp_layout``,
    ``_fsdp_up_layout``); and each call of ``moe_ffn`` that returns
    reduces one DTensor of the (B, S, M) token output, in one
    redistribution (one that remat's recompute stops early at most that
    one), and beside it, where its up-projections split the weights' M, the
    two partial products, (B, E, C, F) DTensors, in one each."""
    cfg = _config(case)
    sites, calls, c, tokens = _step(cfg, kind, mesh2x2, f"{case}-{kind}")
    assert sum(calls.values()) >= cfg.n_layers
    slots = [x for x in sites.seen if _moves_slots(x, cfg, c)]
    assert not slots, slots[:5]
    hidden = (B, cfg.n_experts, c, cfg.d_ff)
    in_moe = [x for x in sites.seen if x.call is not None]
    for call, returned in calls.items():
        got = collections.Counter(
            x.spec[1] if x.spec else None for x in
            {x.spec: x for x in in_moe if x.call == call
             and x.kind in REDUCTIONS}.values())
        want = collections.Counter(
            {tokens: 1, hidden: 2 * sites.ups[call].count("split_m")})
        assert got == +want if returned else \
            got[tokens] <= 1 and got - want == collections.Counter(), \
            (call, got, want, [x for x in in_moe if x.call == call])


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_moe_backward_reduces_the_tokens_grad_once(mesh2x2, case):
    """A train step (remat off, so that no recompute runs inside the
    backward) on meta DTensors of the 2x2 world: while each call of
    ``moe_ffn`` runs its backward, from its output's grad to its input's,
    the one reduction of x's grad, (B, S, M), is one all-reduce of a
    partial sum over model (the mesh dim that splits the experts or F);
    every other reduction is of a weight's grad (FSDP's reduce-scatter
    over data) or of the routing weights', (B, S, k); and no collective
    moves the experts' tokens or their grad."""
    cfg = dataclasses.replace(_config(case), remat=False)
    sites, calls, c, tokens = _step(cfg, "train", mesh2x2, case)
    e, m, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    others = {(e, m, f), (e, f, m), (m, e),
              (B, STEPS["train"], cfg.experts_per_token)}
    assert len(calls) == cfg.n_layers
    for call in calls:
        back = [x for x in sites.seen if x.backward == call]
        assert not [x for x in back if _moves_slots(x, cfg, c)], back
        reduced = [x for x in back if x.kind in REDUCTIONS]
        assert [(x.kind, x.spec[1:]) for x in reduced
                if x.spec[1] not in others] == [
            ("all-reduce", (tokens, "S0,P", "S0,R"))], (call, back)


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_train_step_holds_no_whole_batch_of_tokens(mesh2x2, case):
    """No op of a train step on meta DTensors of the 2x2 world (its
    backward and remat's recompute included) makes a tensor of the whole
    batch's tokens and a zero row, (B, S + 1, M): each rank gathers its
    slots from its own rows, and the dispatch's grad lands in zeros of
    those."""
    cfg = _config(case)
    seq = STEPS["train"]
    whole = (B, seq + 1, cfg.d_model)
    made = []

    class Shapes(dryrun.StepCounter):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is not NotImplemented:
                made.extend((str(func), tuple(t.shape))
                            for t in tree_leaves(out)
                            if isinstance(t, torch.Tensor))
            return out

    with pytest.MonkeyPatch.context() as mp_:
        mp_.setattr(dryrun, "StepCounter", Shapes)
        dryrun.run_cell(cfg, tconfigs.ShapeSpec(case, "train", seq, B),
                        mesh2x2)
    assert made
    assert not [m for m in made if m[1] == whole], \
        [m for m in made if m[1] == whole][:5]


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_decode_step_up_projections_issue_their_closed_form(mesh2x2,
                                                             case):
    """A decode step on meta DTensors of the 2x2 world: while
    ``layers._local_dispatch_and_up`` runs, its collectives are those of
    the layout that ``_fsdp_up_layout`` chose for ``data`` (which splits
    the weights' M), one set a call: under ``"split_m"`` x's rows
    exchanged for its M (an all-to-all, (B, 1, M)), the slot ids' rows
    gathered ((B, E * C)) and the two partial products reduced to the
    hidden's rows ((B, E, C, F), a reduce-scatter each); under
    ``"gather_w"`` we1 and we3 gathered, an all-gather each."""
    cfg = _config(case)
    sites, calls, c, tokens = _step(cfg, "decode", mesh2x2, case)
    e, m, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    # the experts split over model, else F
    cut = "S1" if e % 2 == 0 else "S3"
    w_cut = "S0" if e % 2 == 0 else "S2"
    hidden = ("reduce-scatter", ((B, e, c, f), f"P,{cut}", f"S0,{cut}"))
    closed = {"split_m": [("all-to-all", (tokens, "S0,R", "S2,R")),
                          ("all-gather", ((B, e * c), "S0,R", "R,R")),
                          hidden, hidden],
              "gather_w": [("all-gather", ((e, m, f), f"S1,{w_cut}",
                                           f"R,{w_cut}"))] * 2}
    assert len(calls) == cfg.n_layers
    for call in calls:
        layout, = sites.ups[call]
        got = sorted((x.kind, x.spec[1:]) for x in
                     {x.spec: x for x in sites.seen
                      if x.up and x.call == call}.values())
        assert got == sorted(closed[layout]), (call, layout, got)


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
