"""Fault M (ROADMAP.md, Queue 3): the SSM branch's backward reduces each
grad of its gathers once, on each rank's local shards, in one closed form,
so that every torch release trains mamba2 and hymba with the same program;
on the CPU.

The branch gathers three things over ``model`` (``act_ff``'s mesh dim):
B and C for the SSD, which every head reads; in_proj, whose columns a
product takes in a blocked order; and the conv's weight and bias.  Their
grads were left to DTensor's redistributions, which each release planned
its own way: B's and C's partial sums over the heads reduce-scattered
onto the batch and then exchanged onto N by an all-to-all (one release),
or reduce-scattered onto N at once (another); the chunks' C . B products,
made on DTensors, reduced their operands' partial cotangent by a
collective of its own; and in_proj's blocked grad gathered whole over
``model`` before its reduction over ``data``, 15/16 of it thrown away on a
16x16 mesh.  Now:

- ``sharding.whole_over`` (``_Gathered``): B and C gathered as before;
  in the backward a ``Partial`` sum over ``model`` takes one
  reduce-scatter onto the input's shard, a replicated grad is sliced;
- ``mamba2._chunk_products``: the products in a body on local shards
  that keeps its partial cotangent (``on_local_shards(...,
  partial_grads=True)``), so that its B and C grads add into the scan's
  before that one reduce-scatter;
- ``sharding.weight_blocks`` (``_WeightBlocks``): in_proj's and the
  conv's columns gathered as before; in the backward every block's grad
  joined on each rank, reduced once over the other mesh dims (one
  reduce-scatter over ``data`` for in_proj) and taken back to the
  weight's own column order by one all-to-all over ``model``
  (``_exchange``), never gathered.

On meta DTensors of a fake (data=2, model=2) and (pod=2, data=2, model=2)
world, for the smoke mamba2-780m and hymba-1.5b, a train step's backward
(remat off): issues no all-to-all but those undoing exchanges; B's and C's
grads take one reduce-scatter each a layer and no DTensor redistribution;
no collective moves the products or their operands; no grad of in_proj is
gathered over ``model`` (nor any redistribution of its shape reduced);
the world's and a device's matmul FLOPs are those the program had before
this repair, remat off and on.  On 4 gloo ranks, in fp32, from numpy inputs of a seed:
the grads of in_proj, the conv's weight and bias, ``a_log``, ``dt_bias``
and ``d_skip`` (and every other) match the unsharded port's within 1e-5
of the largest magnitude, as do two train steps' parameters, for the
smoke configs and a variant of one SSD head, whose dt block and in_proj
no mesh dim splits; the closed forms alone on random DTensors against
their unsharded meaning, and ``_onto`` alone against the global tensor
that DTensor's nesting of the shards gives.  On 8 gloo ranks (pod=2,
data=2, model=2) the same for hymba, whose in_proj grad is reduced over
``pod`` after ``data``, the closed forms alone, and ``_onto`` where up to
three mesh dims cut one tensor dim.

This file imports no JAX: it runs on a host that has torch alone.
"""
import dataclasses
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world
from repro_torch.models import hybrid, mamba2
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import place, use_sharding

WORLD = 4
ARCHS = ("mamba2-780m", "hymba-1.5b")
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
SHAPE = tconfigs.ShapeSpec("t", "train", 64, 4)
# the matmul FLOPs of SHAPE's train step before the repair, as the
# program DTensor chose counted them, the world's and a device's:
# (arch, mesh, remat) -> (world, device)
PARENT_FLOPS = {
    ("mamba2-780m", "2x2", False): (153354240, 38535168),
    ("mamba2-780m", "2x2", True): (179306496, 45088768),
    ("mamba2-780m", "2x2x2", False): (153354240, 19267584),
    ("mamba2-780m", "2x2x2", True): (179306496, 22544384),
    ("hymba-1.5b", "2x2", False): (224526336, 56229888),
    ("hymba-1.5b", "2x2", True): (274202624, 68681728),
    ("hymba-1.5b", "2x2x2", False): (224526336, 28114944),
    ("hymba-1.5b", "2x2x2", True): (274202624, 34340864)}
RANKS_TIMEOUT_S = 300


# ------------------------------------------------ meta worlds: collectives
def _mesh(name: str) -> DeviceMesh:
    shape, names = MESHES[name]
    return DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(
        shape), mesh_dim_names=names)


@dataclasses.dataclass
class _Seen:
    kind: str
    node: str | None        # the autograd node running, None in a forward
    shape: tuple | None     # the global shape of the DTensor redistributed
    src: str | None         # its placements before and after, short
    dst: str | None
    group: str              # the mesh dim the collective runs over


def _pls(pls) -> str:
    return ",".join("P" if p.is_partial() else "R" if p.is_replicate()
                    else f"S{p.dim}" for p in pls)


class _Collectives(dryrun.StepCounter):
    """The dry run's counter, which also keeps each collective: its kind,
    the autograd node that issued it (``_GatheredBackward``,
    ``_WeightBlocksBackward``, ...; None outside a backward), the DTensor
    that a redistribution issuing it moves (global shape, placements
    before and after; None where none did) and its mesh dim's name."""

    def __init__(self, args=(), mesh=None):
        super().__init__(args)
        self.seen, self.specs = [], []
        self._groups = {}
        if mesh is not None:
            for m, name in enumerate(mesh.mesh_dim_names):
                self._groups[mesh.get_group(m).group_name] = name

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        kind = self._kinds.get(getattr(func, "_overloadpacket", None))
        if kind is not None and out is not NotImplemented:
            node = torch._C._current_autograd_node()
            spec = self.specs[-1] if self.specs else (None,) * 3
            group = next((self._groups[a] for a in (*args, *(
                kwargs or {}).values()) if isinstance(a, str)
                and a in self._groups), "?")
            self.seen.append(_Seen(kind, None if node is None else
                                   node.name(), *spec, group))
        return out


def _train_step(arch: str, mesh_name: str, remat: bool):
    """The smoke ``arch``'s train step on SHAPE, on meta DTensors of the
    fake ``mesh_name`` world, counted: (the counter, the config)."""
    import torch.distributed.tensor._dispatch as dispatch
    import torch.distributed.tensor._redistribute as redistribute

    cfg = dataclasses.replace(tconfigs.get_smoke_config(arch), remat=remat)
    orig = redistribute.redistribute_local_tensor

    with fake_world(int(np.prod(MESHES[mesh_name][0]))):
        mesh = _mesh(mesh_name)
        with use_sharding(mesh):
            step, args, _ = dryrun.build_step_and_specs(cfg, SHAPE)
            counter = _Collectives(args, mesh)

            def named(local, current, target, *a, **kw):
                counter.specs.append((tuple(current.shape),
                                      _pls(current.placements),
                                      _pls(target.placements)))
                try:
                    return orig(local, current, target, *a, **kw)
                finally:
                    counter.specs.pop()

            with pytest.MonkeyPatch.context() as mp_:
                for mod in (dispatch, redistribute):
                    mp_.setattr(mod, "redistribute_local_tensor", named)
                with dryrun.native_all_to_all(), counter:
                    step(*args)
    return counter, cfg


def _branch(cfg) -> dict:
    """The SSM branch's widths of ``cfg``: d_inner, N, heads, the conv's
    channels, in_proj's columns, the chunk."""
    di = cfg.d_inner if cfg.family == "ssm" else cfg.d_inner_hybrid
    n, h = cfg.ssm_state, di // cfg.ssm_head_dim
    return {"di": di, "n": n, "h": h, "conv": di + 2 * n,
            "in_proj": 2 * di + 2 * n + h, "chunk": cfg.ssm_chunk}


@pytest.fixture(scope="module")
def steps() -> dict:
    """(arch, mesh, remat) -> (counter, config) of each train step."""
    return {(arch, mesh, remat): _train_step(arch, mesh, remat)
            for arch in ARCHS for mesh in MESHES for remat in (False, True)}


CASES = [(arch, mesh) for arch in ARCHS for mesh in MESHES]


def _backward(counter) -> list:
    return [x for x in counter.seen if x.node is not None]


@pytest.mark.parametrize("arch,mesh", CASES)
def test_the_backward_exchanges_only_to_undo_the_blocked_order(
        steps, arch, mesh):
    """Every all-to-all over ``model`` in the backward is one of the
    exchanges that take in_proj's and the conv's blocked grads back to the
    weights' column order: one each a layer for in_proj, the conv's weight
    and its bias; none moves B's or C's grads.  (The lookup's rows go back
    over ``data``: ``layers._rows_back``.)"""
    counter, cfg = steps[(arch, mesh, False)]
    a2a = [x for x in _backward(counter)
           if x.kind == "all-to-all" and x.group == "model"]
    assert all(x.node == "_WeightBlocksBackward" for x in a2a), a2a
    assert len(a2a) == 3 * cfg.n_layers, a2a


@pytest.mark.parametrize("arch,mesh", CASES)
def test_b_and_c_grads_take_one_reduce_scatter_each_a_layer(steps, arch,
                                                            mesh):
    """B's and C's grads, partial sums over the heads' mesh dim, are
    reduced by exactly one reduce-scatter each a layer over ``model``
    (``_GatheredBackward``), nothing else; no DTensor redistribution moves
    a tensor of their (B, S, N) shape in the backward."""
    counter, cfg = steps[(arch, mesh, False)]
    w = _branch(cfg)
    gathered = [x for x in _backward(counter)
                if x.node == "_GatheredBackward"]
    assert [(x.kind, x.group) for x in gathered] == \
        [("reduce-scatter", "model")] * 2 * cfg.n_layers, gathered
    bc = (SHAPE.global_batch, SHAPE.seq_len, w["n"])
    assert not [x for x in _backward(counter) if x.shape == bc], \
        _backward(counter)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_the_chunk_products_add_no_collective(steps, arch, mesh):
    """No collective, forward or backward, moves the chunks' C . B
    products (B, nc, q, q) or their operands (B, nc, q, N).  Left to
    itself, torch 2.11's DTensor already added the operands' grads into
    B's and C's before reducing them: on that release this check guards
    against a regression and shows no fault of its own; on 2.13 it does
    (a reduce-scatter of the operands' partial cotangent)."""
    counter, cfg = steps[(arch, mesh, False)]
    w = _branch(cfg)
    nc = -(-SHAPE.seq_len // w["chunk"])
    shapes = {(SHAPE.global_batch, nc, w["chunk"], w["chunk"]),
              (SHAPE.global_batch, nc, w["chunk"], w["n"])}
    assert not [x for x in counter.seen if x.shape in shapes], counter.seen


@pytest.mark.parametrize("arch,mesh", CASES)
def test_in_proj_grad_is_never_gathered_over_model(steps, arch, mesh):
    """The backward gathers nothing in the weights' closed form
    (``_WeightBlocksBackward``) and redistributes no grad of in_proj's
    shape, whole or blocked (a partial sum); each layer reduces in_proj's
    grad once over ``data`` (a reduce-scatter onto its rows) and once
    over ``pod`` (an all-reduce of the rows' shard) where the mesh has
    one, and the conv's weight and bias once over each, all-reduced: they
    are replicated there."""
    counter, cfg = steps[(arch, mesh, False)]
    w = _branch(cfg)
    ours = [x for x in _backward(counter)
            if x.node == "_WeightBlocksBackward"]
    assert not [x for x in ours if x.kind == "all-gather"], ours
    M = cfg.d_model
    grads = [x for x in _backward(counter) if x.shape is not None and
             len(x.shape) == 2 and x.shape[0] == M and x.shape[1] in (
                 w["in_proj"], 2 * w["di"] + 2 * w["n"]) and "P" in x.src]
    assert not grads, grads
    pods = MESHES[mesh][1][:-2]
    per_layer = sorted(
        [("reduce-scatter", "data")] + [("all-reduce", p) for p in pods] +
        2 * [("all-reduce", d) for d in (*pods, "data")] +
        3 * [("all-to-all", "model")])
    got = sorted((x.kind, x.group) for x in ours)
    assert got == sorted(per_layer * cfg.n_layers), got


@pytest.mark.parametrize("remat", [False, True], ids=["off", "nothing"])
@pytest.mark.parametrize("arch,mesh", CASES)
def test_the_step_keeps_its_flops(steps, arch, mesh, remat):
    """The world's and a device's matmul FLOPs of the train step are those
    before the repair; the world's are the unsharded step's."""
    counter, cfg = steps[(arch, mesh, remat)]
    assert counter.totals() == PARENT_FLOPS[(arch, mesh, remat)]
    with use_sharding(None):
        step, args, _ = dryrun.build_step_and_specs(cfg, SHAPE)
        plain = dryrun.StepCounter(args)
        with plain:
            step(*args)
    assert counter.totals()[0] == plain.totals()[0]


# ------------------------------------------------ 4 gloo ranks: values
# the train runs: name -> (arch, config changes); "one-head": mamba2 with
# one SSD head, so that model splits neither the dt block (1 column) nor
# in_proj (289 columns) nor the heads: the blocks whole, B's and C's grads
# replicated, in_proj's grad gathered over model as its parameter is whole
RUNS = {"mamba2-780m": ("mamba2-780m", {}), "hymba-1.5b": ("hymba-1.5b", {}),
        "mamba2-780m:one-head": ("mamba2-780m", {"ssm_head_dim": 128})}
TRAIN_STEPS, B, SEQ = 2, 4, 40
# the SSM branch's parameters whose grads the closed forms reduce, and
# those of the scan (each arch's names)
SSM_PARAMS = {"ssm": ("layers.in_proj.w", "layers.conv.w", "layers.conv.b",
                      "layers.a_log", "layers.dt_bias", "layers.d_skip"),
              "hybrid": ("layers.ssm.in_proj", "layers.ssm.conv.w",
                         "layers.ssm.conv.b", "layers.ssm.a_log",
                         "layers.ssm.dt_bias", "layers.ssm.d_skip")}
# the closed forms alone: case -> (the blocks' widths, joined); w (M,
# sum of the widths) split over model where the sum divides 2
BLOCK_CASES = {"split": ((4, 6, 2), False), "split-joined": ((4, 6, 2), True),
               "mixed": ((4, 3, 3), False), "mixed-joined": ((4, 3, 3), True),
               "whole": ((4, 3, 2), True)}
BLOCK_M, GATHER_H = 8, 4
# the run on three mesh dims: hymba, whose in_proj grad is reduced over
# pod after data
POD_RUN = "hymba-1.5b"
# ``_onto`` alone: mesh -> case -> (a grad's placements, the wanted ones),
# "P" a Partial sum, "R" replicated, "S<d>" a shard of dim d; a new cut of
# dim 0 where an inner mesh dim holds one already ("inner-held") must nest
# as DTensor does, the outer mesh dim's chunk first
ONTO_CASES = {
    "2x2": {"outer-held": ("S0,P", "S0,S0"), "inner-held": ("P,S0", "S0,S0"),
            "inner-held-sliced": ("R,S0", "S0,S0"),
            "both-cut": ("P,P", "S0,S0"), "summed": ("P,S1", "R,S1")},
    "2x2x2": {"outer-held": ("S0,P,P", "S0,S0,S0"),
              "inner-held": ("P,P,S0", "S0,S0,S0"),
              "middle-held": ("P,S0,R", "S0,S0,S0"),
              "summed": ("P,S0,P", "R,S0,S1")}}
ONTO_SHAPE = (16, 4)


def _cfg(run: str):
    arch, changes = RUNS[run]
    return dataclasses.replace(tconfigs.get_smoke_config(arch),
                               remat=False, **changes)


def _np(t: torch.Tensor) -> np.ndarray:
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    return t.detach().numpy()


def _train(run: str, mesh=None) -> dict:
    """``run``'s smoke model in fp32 activations under ``mesh`` (None:
    unsharded), weights and tokens from a seed: every grad of
    ``loss_and_grads`` (``grad.<name>``) and every parameter after each
    of TRAIN_STEPS ``make_train_step``s (``step<i>.<name>``), whole."""
    from repro_torch.models import get_model, loss_and_grads, make_train_step
    from repro_torch.optimizer import adamw_init

    cfg = _cfg(run)
    model = get_model(cfg)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (B, SEQ + 1)).astype(np.int32)
    out = {}
    with pytest.MonkeyPatch.context() as mp_, use_sharding(mesh):
        for mod in (mamba2, hybrid):
            mp_.setattr(mod, "ACT_DTYPE", torch.float32)
        params = {k: place(torch.from_numpy((0.2 * rng.standard_normal(
            d.shape)).astype(np.float32)), d.names)
            for k, d in sorted(model.param_defs().items())}
        batch = {k: place(torch.from_numpy(v), ("batch", "seq")) for k, v in
                 (("tokens", toks[:, :-1]), ("targets", toks[:, 1:]))}
        grads, _ = loss_and_grads(model, params, batch)
        out.update({f"grad.{k}": _np(g) for k, g in grads.items()})
        step, opt = make_train_step(model), adamw_init(params)
        for i in range(TRAIN_STEPS):
            params, opt, _ = step(params, opt, batch)
            out.update({f"step{i}.{k}": _np(p) for k, p in params.items()})
    return out


def _blocks(case: str, mesh=None) -> dict:
    """The closed forms alone under ``mesh`` (None: their unsharded
    meaning): ``weight_blocks`` of a weight w (BLOCK_M, d) laid out as
    in_proj (``embed``, ``ff``), each block multiplied by rows h split over
    ``data`` and summed against a cotangent, so that each block's grad is
    a partial sum over ``data``; and ``whole_over`` of b (B, SEQ, N) split
    over ``model``, read by a body whose heads split ``model`` (its grad a
    partial sum there) and by a product with a replicated cotangent.
    Returns the loss's grads of w, h and b, whole."""
    widths, joined = BLOCK_CASES[case]
    d, n = sum(widths), 4
    rng = np.random.default_rng(7)
    a = {"w": rng.standard_normal((BLOCK_M, d)),
         "h": rng.standard_normal((B, SEQ, BLOCK_M)),
         "g": rng.standard_normal((B, SEQ, d)),
         "b": rng.standard_normal((B, SEQ, n)),
         "x": rng.standard_normal((B, SEQ, GATHER_H, n)),
         "gy": rng.standard_normal((B, SEQ, GATHER_H)),
         "gb": rng.standard_normal((B, SEQ, n))}
    names = {"w": ("embed", "ff"), "h": ("batch", "seq", None),
             "g": ("batch", "seq", None), "b": ("batch", "seq", "act_ff"),
             "x": ("batch", "seq", "act_heads", None),
             "gy": ("batch", "seq", "act_heads"), "gb": ("batch", "seq", None)}
    offs = [sum(widths[:i]) for i in range(len(widths))]
    with use_sharding(mesh):
        t = {k: place(torch.from_numpy(v.astype(np.float32)), names[k])
             for k, v in a.items()}
        for k in ("w", "h", "b", "x"):
            t[k] = t[k].detach().requires_grad_()

        def scan(b, x):
            return (x * b[:, :, None, :]).sum(-1)

        if mesh is None:
            blocks = [t["w"][:, o:o + n] for o, n in zip(offs, widths)]
            bg = t["b"]
            y = scan(bg, t["x"])
        else:
            m = mesh.mesh_dim_names.index("model")
            split = [n % mesh.size(m) == 0 for n in widths]
            got = list(sharding.weight_blocks(t["w"], list(zip(offs, widths)),
                                              split, m, joined=joined))
            if joined and any(split):
                got = list(sharding.split_blocked(
                    got.pop(0), [n for n, s in zip(widths, split) if s], m)
                ) + got
                order = [i for i, s in enumerate(split) if s] + \
                    [i for i, s in enumerate(split) if not s]
                blocks = [got[order.index(i)] for i in range(len(widths))]
            else:
                blocks = got
            bg = sharding.whole_over(t["b"], m)
            pls = tuple(t["x"].placements)
            rows = sharding.rows_of(t["x"])
            y = sharding.on_local_shards(scan, [(bg, rows), (t["x"], pls)],
                                         [pls])[0]
        loss = sum(((t["h"] @ blk) * t["g"][..., o:o + n]).sum()
                   for blk, o, n in zip(blocks, offs, widths))
        loss = loss + (y * t["gy"]).sum() + (bg * t["gb"]).sum()
        loss.backward()
    return {k: _np(t[k].grad) for k in ("w", "h", "b", "x")}


def _parse(pls: str) -> list:
    from torch.distributed.tensor import Partial, Replicate, Shard

    return [Partial() if p == "P" else Replicate() if p == "R" else
            Shard(int(p[1:])) for p in pls.split(",")]


def _onto(case: tuple, mesh=None) -> dict:
    """``sharding._onto`` alone, ``case`` (mesh name, case of ONTO_CASES):
    a DTensor of ONTO_SHAPE laid out as the case's grad placements, each
    rank's local shard drawn from a seed by its coordinates (equal along
    a replicated mesh dim), taken to the wanted placements; returns the
    result, whole.  Without ``mesh`` the global tensor those shards mean
    in DTensor's nesting (a Partial dim summed, the shards of one tensor
    dim placed outer mesh dim first)."""
    import itertools

    from torch.distributed.tensor import DTensor

    mesh_name, name = case
    have, want = (_parse(p) for p in ONTO_CASES[mesh_name][name])
    sizes = MESHES[mesh_name][0]
    local = list(ONTO_SHAPE)
    for T, p in zip(sizes, have):
        if p.is_shard():
            local[p.dim] //= T
    vals = np.random.default_rng(11).standard_normal(
        (*sizes, *local)).astype(np.float32)

    def mine(coord):
        return vals[tuple(0 if p.is_replicate() else c
                          for c, p in zip(coord, have))]

    if mesh is None:
        out = np.zeros(ONTO_SHAPE, np.float32)
        for coord in itertools.product(*map(range, sizes)):
            if any(c and p.is_replicate() for c, p in zip(coord, have)):
                continue
            at = []
            for d in range(len(ONTO_SHAPE)):
                chunk = 0
                for T, c, p in zip(sizes, coord, have):
                    if p.is_shard() and p.dim == d:
                        chunk = chunk * T + c
                at.append(slice(chunk * local[d], (chunk + 1) * local[d]))
            out[tuple(at)] += mine(coord)
        return {"g": out}
    g = DTensor.from_local(
        torch.from_numpy(mine(mesh.get_coordinate()).copy()), mesh, have,
        run_check=False, shape=torch.Size(ONTO_SHAPE),
        stride=sharding._global_stride(ONTO_SHAPE))
    got = DTensor.from_local(
        sharding._onto(g, want), mesh, want, run_check=False,
        shape=torch.Size(ONTO_SHAPE),
        stride=sharding._global_stride(ONTO_SHAPE))
    return {"g": got.full_tensor().numpy()}


def _runs(what: str) -> dict:
    """name -> (the function that makes its outputs, its argument):
    ``what`` "train", each run's ``_train`` (on 2x2), "blocks", each block
    case's ``_blocks`` and each 2x2 ``_onto`` case, or "pod", on 2x2x2,
    POD_RUN's ``_train``, each block case and each 2x2x2 ``_onto``
    case."""
    if what == "train":
        return {run: (_train, run) for run in RUNS}
    mesh = "2x2" if what == "blocks" else "2x2x2"
    out = {f"blocks_{case}": (_blocks, case) for case in BLOCK_CASES}
    out.update({f"onto_{case}": (_onto, (mesh, case))
                for case in ONTO_CASES[mesh]})
    if what == "pod":
        out[POD_RUN] = (_train, POD_RUN)
    return out


def _rank_main(rank: int, tmp: str, what: str, mesh_name: str) -> None:
    """One of the gloo ranks of mesh ``mesh_name``: ``_runs(what)`` on
    it, each written to ``rank{rank}_{name}.npz``."""
    torch.set_num_threads(1)
    tmp = Path(tmp)
    world = int(np.prod(MESHES[mesh_name][0]))
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp / "store"), world), rank=rank, world_size=world)
    try:
        mesh = _mesh(mesh_name)
        for name, (fn, arg) in _runs(what).items():
            np.savez(tmp / f"rank{rank}_{name}.npz", **fn(arg, mesh))
    finally:
        dist.destroy_process_group()


def _ranks(tmp: Path, what: str, mesh_name: str = "2x2") -> dict:
    """name -> {"sharded": rank 0's outputs, "port": the unsharded ones}
    of ``_runs(what)`` on the gloo ranks of mesh ``mesh_name``; every
    rank's outputs are equal."""
    world = int(np.prod(MESHES[mesh_name][0]))
    procs = mp.start_processes(_rank_main, args=(str(tmp), what, mesh_name),
                               nprocs=world, join=False,
                               start_method="spawn")
    out = {name: {"port": fn(arg)}
           for name, (fn, arg) in _runs(what).items()}
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    while not procs.join(timeout=5):
        if time.monotonic() > deadline:
            for p in procs.processes:
                p.kill()
            raise TimeoutError(f"the {world} ranks ran past "
                               f"{RANKS_TIMEOUT_S} s")
    for name in out:
        got = [dict(np.load(tmp / f"rank{r}_{name}.npz"))
               for r in range(world)]
        for other in got[1:]:
            assert all(np.array_equal(other[k], got[0][k]) for k in got[0])
        out[name]["sharded"] = got[0]
    return out


@pytest.fixture(scope="module")
def trains(tmp_path_factory) -> dict:
    return _ranks(tmp_path_factory.mktemp("ssm_train4"), "train")


@pytest.fixture(scope="module")
def blocks(tmp_path_factory) -> dict:
    return _ranks(tmp_path_factory.mktemp("ssm_blocks4"), "blocks")


@pytest.fixture(scope="module")
def pods(tmp_path_factory) -> dict:
    return _ranks(tmp_path_factory.mktemp("ssm_pod8"), "pod", "2x2x2")


def _close(got: np.ndarray, want: np.ndarray, what: str) -> None:
    assert np.abs(want).max() > 0, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("run", RUNS)
def test_the_ssm_grads_match_unsharded(trains, run):
    """On the 2x2 mesh the grads of the SSM branch's parameters (in_proj,
    the conv's weight and bias, a_log, dt_bias, d_skip), and every other
    grad, match the unsharded port's in fp32, each within 1e-5 of its
    largest magnitude."""
    got, want = trains[run]["sharded"], trains[run]["port"]
    names = SSM_PARAMS[_cfg(run).family]
    assert {f"grad.{k}" for k in names} <= set(want)
    for k in sorted(k for k in want if k.startswith("grad.")):
        _close(got[k], want[k], k)


@pytest.mark.parametrize("run", RUNS)
def test_two_train_steps_match_unsharded(trains, run):
    """Two ``make_train_step``s on the 2x2 mesh, the second on the first's
    outputs: every parameter after each within 1e-5 of its largest
    magnitude of the unsharded run's."""
    got, want = trains[run]["sharded"], trains[run]["port"]
    for k in sorted(k for k in want if k.startswith("step")):
        _close(got[k], want[k], k)


@pytest.mark.parametrize("case", BLOCK_CASES)
def test_the_closed_forms_alone_match_unsharded(blocks, case):
    """``weight_blocks`` (every block split, some whole while the weight's
    columns split over model, the weight whole there; joined or not) and
    ``whole_over`` (its grad a partial sum over model and a replicated one):
    the grads of the weight, the rows and b against their unsharded
    meaning."""
    got, want = blocks[f"blocks_{case}"]["sharded"], \
        blocks[f"blocks_{case}"]["port"]
    for k in want:
        _close(got[k], want[k], k)


@pytest.mark.parametrize("mesh,case", [(mesh, case) for mesh in ONTO_CASES
                                       for case in ONTO_CASES[mesh]])
def test_onto_nests_the_shards_as_dtensor(blocks, pods, mesh, case):
    """``_onto`` on 4 and 8 gloo ranks: a grad's local shard taken to the
    wanted placements is the global tensor's shard there, in DTensor's
    nesting, also where an inner mesh dim already cuts the tensor dim
    that an outer one now reduce-scatters or slices onto."""
    runs = blocks if mesh == "2x2" else pods
    got, want = runs[f"onto_{case}"]["sharded"], runs[f"onto_{case}"]["port"]
    _close(got["g"], want["g"], f"{mesh} {case}")


@pytest.mark.parametrize("case", BLOCK_CASES)
def test_the_closed_forms_alone_match_unsharded_on_three_mesh_dims(pods,
                                                                   case):
    """As ``test_the_closed_forms_alone_match_unsharded``, on 8 gloo ranks
    (pod=2, data=2, model=2): the weight's grad reduced over pod and data,
    the rows' batch split over both."""
    got, want = pods[f"blocks_{case}"]["sharded"], \
        pods[f"blocks_{case}"]["port"]
    for k in want:
        _close(got[k], want[k], k)


def test_the_ssm_grads_and_train_steps_match_on_three_mesh_dims(pods):
    """POD_RUN (hymba) on 8 gloo ranks (pod=2, data=2, model=2): every
    grad, the SSM branch's among them (in_proj's reduced over data and
    then pod), and every parameter after two train steps, within 1e-5 of
    its largest magnitude of the unsharded port's."""
    got, want = pods[POD_RUN]["sharded"], pods[POD_RUN]["port"]
    names = SSM_PARAMS[_cfg(POD_RUN).family]
    assert {f"grad.{k}" for k in names} <= set(want)
    for k in sorted(want):
        _close(got[k], want[k], k)
