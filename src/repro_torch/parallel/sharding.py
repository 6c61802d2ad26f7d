"""Logical-axis sharding rules (MaxText-style) with divisibility fallback, on
``torch.distributed``'s DeviceMesh and DTensor.  Twin of
``repro.parallel.sharding``.

Model code names tensor dimensions with *logical* axes ("batch", "embed",
"heads", ...).  A rule table maps logical axes to mesh axes; `logical_spec`
resolves a shape + names into a `PartitionSpec`, dropping mesh axes that do
not divide the dimension, by the reference's rules.  A mesh is a
``DeviceMesh`` whose ``mesh_dim_names`` are the JAX axis names ("pod",
"data", "model"); anything with a ``.shape`` mapping axis names to sizes
serves as a fake mesh for resolving specs.  `placements` turns a spec into
DTensor placements over a mesh, in JAX's major-to-minor chunk order.

The context (mesh + rules) is stored in a contextvar, so model code can call
``constrain(x, "batch", "seq", "embed")`` without threading a mesh handle
through every function.  Outside a context ``constrain`` is a no-op, as in
JAX.  Under a mesh it redistributes a DTensor, and its grad in the
backward, and returns a plain tensor unchanged: eager PyTorch has no
compiler to take an annotation.  A tensor that model code makes (an
``arange``, a mask) meets DTensors under a mesh as a replicated one
(``replicate_as``), where JAX's tracer takes it in as a constant.

``torch.distributed`` is imported inside the functions that need it, so
importing this module (or `pad_to_multiple` and `operand_footprint` from it)
costs a user of ``repro_torch.core`` nothing.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import math
from typing import Any, Sequence

import torch

# logical axis -> tuple of mesh axes (in sharding-priority order)
LOGICAL_RULES: dict[str, tuple[str, ...]] = {
    # activations
    "batch": ("pod", "data"),      # global batch over pods x data
    "seq": (),                     # sequence unsharded by default (SP opt-in)
    "seq_shard": ("model",),       # opt-in sequence parallelism
    "kv_seq": ("data", "model"),   # long-context KV/state sharding (batch=1)
    "act_embed": (),               # activation d_model dim
    "act_heads": ("model",),       # activation heads dim
    "act_ff": ("model",),          # activation FFN hidden dim
    "act_expert": ("model",),      # activation expert dim
    # weights
    "embed": ("data",),            # FSDP/ZeRO-3 dim of weight matrices
    "heads": ("model",),           # TP: q heads
    "kv_heads": ("model",),        # TP: kv heads
    "ff": ("model",),              # TP: FFN hidden
    "vocab": ("model",),           # TP: embedding/LM-head vocab dim
    "expert": ("model",),          # EP: expert dim of MoE weights
    "layers": (),                  # scanned layer dim: replicated
    "conv": (),                    # small conv / misc dims
    "state": (),                   # SSM state dim
    "head_dim": (),
}


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: one entry per tensor dim, each ``None``, a
    mesh axis name, or a tuple of names (major to minor)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """axis name -> size of a DeviceMesh, or of a fake mesh's ``.shape``."""
    if mesh is None:
        return {}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


@dataclasses.dataclass
class ShardingCtx:
    mesh: Any
    rules: dict[str, tuple[str, ...]]

    def axis_size(self, axis: str) -> int:
        return mesh_axis_sizes(self.mesh).get(axis, 1)


_CTX: contextvars.ContextVar[ShardingCtx | None] = contextvars.ContextVar(
    "repro_torch_sharding_ctx", default=None)


def current_ctx() -> ShardingCtx | None:
    return _CTX.get()


@contextlib.contextmanager
def use_sharding(mesh, rules: dict[str, tuple[str, ...]] | None = None):
    """Install a sharding context for model code."""
    with reentered(ShardingCtx(mesh=mesh, rules=dict(rules or
                                                      LOGICAL_RULES))) as ctx:
        yield ctx


@contextlib.contextmanager
def reentered(ctx: ShardingCtx | None):
    """Install ``ctx``, a ``current_ctx()`` taken earlier, while open: code
    run again on another thread sees the context its first run saw.  A
    recomputed region (``models.layers.remat``) runs again in the backward,
    on the autograd engine's device thread for CUDA tensors, where the
    context variable is unset."""
    token = _CTX.set(ctx)
    try:
        yield ctx
    finally:
        _CTX.reset(token)


def set_rules(overrides: dict[str, tuple[str, ...]]) -> None:
    """Mutate the *current* context's rules (hillclimb knob)."""
    ctx = current_ctx()
    if ctx is None:
        raise RuntimeError("no active sharding context")
    ctx.rules.update(overrides)


def logical_spec(shape: Sequence[int], names: Sequence[str | None],
                 ctx: ShardingCtx | None = None) -> PartitionSpec:
    """Resolve logical names to a PartitionSpec, enforcing divisibility.

    A dim gets the *largest prefix* of its rule's mesh axes whose product
    divides the dim size; mesh axes already used by another dim are skipped
    (an axis shards at most one dim), and so are axes of size 1.
    """
    ctx = ctx or current_ctx()
    if ctx is None or ctx.mesh is None:
        return P()
    if len(shape) != len(names):
        raise ValueError(f"shape {shape} vs names {names} length mismatch")
    used: set[str] = set()
    out: list = []
    for dim, name in zip(shape, names):
        if name is None:
            out.append(None)
            continue
        axes = ctx.rules.get(name, ())
        chosen: list[str] = []
        prod = 1
        for ax in axes:
            size = ctx.axis_size(ax)
            if size <= 1 or ax in used:
                continue
            if dim % (prod * size) == 0:
                chosen.append(ax)
                prod *= size
            else:
                break  # keep prefix-order semantics (pod before data, etc.)
        used.update(chosen)
        if not chosen:
            out.append(None)
        elif len(chosen) == 1:
            out.append(chosen[0])
        else:
            out.append(tuple(chosen))
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def placements(spec: PartitionSpec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: a shard of tensor dim d
    on every mesh dim that d's entry names, ``Replicate()`` elsewhere.

    JAX splits a dim over a tuple of axes major to minor in the tuple's
    order; DTensor splits in mesh-dim order.  Where the tuple puts a later
    mesh dim first (``("model", "data")`` on a ``(data, model)`` mesh), the
    earlier mesh dim takes a ``_StridedShard`` whose split factor is the
    size of the axes ahead of it, which gives coordinate (d, m) JAX's chunk
    m * D + d."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    names = list(mesh.mesh_dim_names)
    sizes = mesh_axis_sizes(mesh)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        for j, ax in enumerate(axes):
            i = names.index(ax)
            split = math.prod(sizes[a] for a in axes[:j]
                              if names.index(a) > i)
            out[i] = Shard(dim) if split == 1 else \
                _StridedShard(dim, split_factor=split)
    return out


def logical_sharding(shape: Sequence[int], names: Sequence[str | None],
                     ctx: ShardingCtx | None = None):
    """``(mesh, placements)`` of the named dims under the context's mesh,
    or None outside one."""
    ctx = ctx or current_ctx()
    if ctx is None or ctx.mesh is None:
        return None
    return ctx.mesh, placements(logical_spec(shape, names, ctx), ctx.mesh)


def _global_stride(shape: Sequence[int]) -> tuple:
    return tuple(math.prod(shape[d + 1:]) for d in range(len(shape)))


def abstract_tensor(shape: Sequence[int], dtype: torch.dtype, sharding=None
                    ) -> torch.Tensor:
    """The port's ``jax.ShapeDtypeStruct``: a meta tensor of ``shape`` and
    ``dtype``; with a ``sharding`` (``logical_sharding``'s) a DTensor on its
    mesh whose local shard, on the meta device, has this rank's shape."""
    if sharding is None:
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    mesh, pls = sharding
    local = list(shape)
    for i, pl in enumerate(pls):
        if isinstance(pl, (Shard, _StridedShard)):
            local[pl.dim] //= mesh.size(i)
    return DTensor.from_local(
        torch.empty(local, dtype=dtype, device="meta"), mesh, pls,
        run_check=False, shape=torch.Size(shape),
        stride=_global_stride(shape))


class _Constrain(torch.autograd.Function):
    """Redistribution to ``target`` placements on ``mesh``, and of the grad
    to the same placements in the backward, as JAX's
    ``with_sharding_constraint`` constrains a cotangent too (DTensor's own
    ``redistribute`` takes the grad back to the input's placements, and
    records nothing where they are the target already).  Each local shard
    is made contiguous: a shard cut from the last dim is a strided view,
    which DTensor's local ``view`` (inside ``einsum``) cannot take."""

    @staticmethod
    def forward(ctx, x, mesh, target):
        ctx.mesh, ctx.target = mesh, target
        return x.redistribute(mesh, target).contiguous().view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(ctx.mesh, ctx.target).contiguous(), None, \
            None


class _Widened(torch.autograd.Function):
    """``x`` redistributed to ``target`` placements and widened to float32
    (float64 stays).  Backward: the grad, in the wide type, is taken back
    to x's own placements (a ``Partial`` sum across the ranks reduced
    there) and only then cast to x's dtype, so that each of its values is
    rounded once, after every sum, as GSPMD reduces the reference's fp32
    einsum before its one cast."""

    @staticmethod
    def forward(ctx, x, mesh, target):
        ctx.mesh, ctx.pls, ctx.dtype = mesh, tuple(x.placements), x.dtype
        return x.redistribute(mesh, target).to(
            torch.promote_types(x.dtype, torch.float32))

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(ctx.mesh, ctx.pls).to(ctx.dtype), None, \
            None


class _Gathered(torch.autograd.Function):
    """DTensor ``x`` gathered over ``mesh_dim``, which splits it
    (``Shard``), its other placements kept, its local shard contiguous
    (``_Constrain``'s reason).  Backward, on the local shard, in one
    closed form whatever DTensor's release would plan: the grad taken to
    x's placements (``_onto``), so over ``mesh_dim`` a ``Partial`` sum is
    reduced by one reduce-scatter onto x's shard and a replicated grad is
    sliced to it, with no collective."""

    @staticmethod
    def forward(ctx, x, mesh_dim):
        from torch.distributed.tensor import Replicate

        ctx.pls, ctx.shape = tuple(x.placements), x.shape
        pls = list(x.placements)
        pls[mesh_dim] = Replicate()
        return x.redistribute(x.device_mesh, pls).contiguous()

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(
            _onto(grad, ctx.pls).contiguous(), grad.device_mesh, ctx.pls,
            run_check=False, shape=ctx.shape,
            stride=_global_stride(ctx.shape)), None


def _reduce_scatter(*args):
    """funcol's reduce-scatter of a tensor along a dim: ``reduce_scatter_
    single`` where the release has it (2.13, which deprecates the older
    name), ``reduce_scatter_tensor`` before; one op underneath."""
    from torch.distributed import _functional_collectives as funcol

    return getattr(funcol, "reduce_scatter_single",
                   funcol.reduce_scatter_tensor)(*args)


def _in_closed_form(p, q) -> bool:
    """Whether ``_onto`` takes placement ``p`` to ``q`` on a mesh dim by a
    collective of its own: kept, a sum reduce-scattered onto a shard or
    all-reduced, or a replicated dim sliced to a shard."""
    from torch.distributed.tensor import Shard

    return p == q or (type(q) is Shard or q.is_replicate()) and (
        p.is_partial() and p.reduce_op == "sum") or (
        p.is_replicate() and type(q) is Shard)


def _nested(have: Sequence, want: Sequence) -> bool:
    """Whether each tensor dim that ``want`` cuts on a mesh dim where
    ``have`` does not is cut in ``have`` only by plain ``Shard``s of outer
    mesh dims: cutting the local shard then nests as DTensor nests the
    shards of one dim, outer mesh dim first."""
    from torch.distributed.tensor import Shard

    return all(k < m and type(p) is Shard
               for m, q in enumerate(want) if type(q) is Shard and
               have[m] != q
               for k, p in enumerate(have) if is_shard(p) and p.dim == q.dim)


def _onto(g: torch.Tensor, want: Sequence) -> torch.Tensor:
    """The local shard of DTensor ``g`` laid out as ``want`` (placements on
    g's mesh), by funcol's collectives on the shard, one a mesh dim whose
    placement changes: a ``Partial`` sum reduce-scattered onto a ``Shard``,
    or all-reduced to a ``Replicate`` after every reduce-scatter (on the
    smaller shard); a replicated dim sliced to a ``Shard``.  Any other
    change, a shard that does not divide evenly, or a new cut of a tensor
    dim that an inner mesh dim cuts already (``_nested``), is left to
    DTensor's redistribute."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Shard

    mesh, have, want = g.device_mesh, list(g.placements), list(want)
    cuts = [(m, q.dim) for m, q in enumerate(want) if type(q) is Shard]
    if any(g.shape[d] % math.prod(mesh.size(m) for m, e in cuts if e == d)
           for _, d in cuts) or not all(map(_in_closed_form, have, want)) \
            or not _nested(have, want):
        return g.redistribute(mesh, want).to_local()
    local, coord = g.to_local(), mesh.get_coordinate()
    for m, (p, q) in enumerate(zip(have, want)):
        if p == q or type(q) is not Shard:
            continue
        if p.is_partial():
            local = funcol.wait_tensor(_reduce_scatter(
                local.contiguous(), "sum", q.dim, (mesh, m)))
        else:
            n = local.shape[q.dim] // mesh.size(m)
            local = local.narrow(q.dim, coord[m] * n, n)
    dims = [m for m, (p, q) in enumerate(zip(have, want))
            if p.is_partial() and q.is_replicate()]
    return all_reduce_over(local.contiguous() if dims else local, "sum",
                           mesh, dims)


def widened(x: torch.Tensor, target: Sequence) -> torch.Tensor:
    """DTensor ``x`` at ``target`` placements in float32, its grad summed
    across the ranks in float32 and cast to x's dtype once
    (``_Widened``); ``x`` itself where it is float32 or wider already."""
    target = tuple(target)
    if torch.promote_types(x.dtype, torch.float32) == x.dtype:
        return x
    return _Widened.apply(x, x.device_mesh, target)


def constrain(x: torch.Tensor, *names: str | None,
              shape: Sequence[int] | None = None) -> torch.Tensor:
    """A DTensor redistributed to the named placements under a mesh, its
    grad too; any other tensor, or any tensor outside a mesh, unchanged.
    ``shape`` resolves the names against another shape of x's rank, as that
    of a dim about to be split whose leading factor must take its sharding
    (``layers.split_heads``)."""
    ctx = current_ctx()
    if ctx is None or ctx.mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    spec = logical_spec(x.shape if shape is None else shape, names, ctx)
    return _Constrain.apply(x, ctx.mesh, tuple(placements(spec, ctx.mesh)))


def grad_placed(x: torch.Tensor) -> torch.Tensor:
    """DTensor ``x`` as it is, its grad taken in the backward to x's own
    placements (a ``Partial`` sum reduced once there), where DTensor
    would leave it to whichever op the grad meets next (``_Constrain``)."""
    return _Constrain.apply(x, x.device_mesh, tuple(x.placements))


def is_sharded(t: torch.Tensor) -> bool:
    """Whether ``t`` is a DTensor under a mesh context."""
    if current_ctx() is None:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def replicate_as(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t``, a tensor that model code made (an ``arange``, a mask), as a
    DTensor replicated over the mesh of ``like`` where ``like`` is a
    DTensor under a mesh context; otherwise ``t`` unchanged.  JAX needs no
    such step: its tracer takes a constant into the sharded program."""
    if not is_sharded(like) or is_sharded(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def is_shard(pl) -> bool:
    """Whether placement ``pl`` splits a tensor dim (``Shard`` or
    ``_StridedShard``, which torch 2.13 no longer derives from ``Shard``)."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    return isinstance(pl, (Shard, _StridedShard))


def shard_bounds(shape: Sequence[int], mesh, pls: Sequence,
                 dim: int) -> tuple[int, int]:
    """[start, stop) of the global indices along ``dim`` that this rank's
    shard of a tensor of ``shape`` laid out as ``pls`` on ``mesh`` holds.
    A dim that ``_StridedShard``s split too is split evenly in JAX's
    major-to-minor chunk order (``placements``' layout, each chunk
    contiguous): the order whose split factors ``placements`` would give,
    the chunk the rank's coordinates in that order."""
    import itertools

    from torch.distributed.tensor import Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    dims = [m for m, p in enumerate(pls) if is_shard(p) and p.dim == dim]
    if all(type(pls[m]) is Shard for m in dims):
        local, offset = compute_local_shape_and_global_offset(
            torch.Size(shape), mesh, list(pls))
        return offset[dim], offset[dim] + local[dim]
    split = {m: getattr(pls[m], "split_factor", 1) for m in dims}
    order = next(o for o in itertools.permutations(dims) if all(
        split[m] == math.prod(mesh.size(a) for a in o[:j] if a > m)
        for j, m in enumerate(o)))
    coord, chunk = mesh.get_coordinate(), 0
    for m in order:
        chunk = chunk * mesh.size(m) + coord[m]
    size = shape[dim] // math.prod(mesh.size(m) for m in dims)
    return chunk * size, (chunk + 1) * size


def rows_of(t: torch.Tensor) -> list:
    """Placements of DTensor ``t``'s rows: its splits of dim 0 (the batch)
    kept, replicated on every other mesh dim."""
    from torch.distributed.tensor import Replicate

    return [p if is_shard(p) and p.dim == 0 else Replicate()
            for p in t.placements]


def summed_to_rows(t: torch.Tensor) -> torch.Tensor:
    """DTensor ``t`` with every ``Partial`` sum it holds reduced where it
    lies: to a shard of its rows (dim 0) where the logical ``batch`` splits
    them over that mesh dim, whole there elsewhere (a batch of one); ``t``
    itself where it holds none.  A product whose contraction a mesh dim
    splits while its rows are whole there (FSDP's ``embed`` under a batch
    of one) is such a sum, which no op that is not linear may read."""
    from torch.distributed.tensor import Replicate, Shard

    if not any(p.is_partial() for p in t.placements):
        return t
    rows = placements(logical_spec((t.shape[0],), ("batch",)), t.device_mesh)
    return t.redistribute(t.device_mesh, [
        (Shard(0) if is_shard(r) else Replicate()) if p.is_partial() else p
        for p, r in zip(t.placements, rows)])


def all_reduce_over(t: torch.Tensor, op: str, mesh, dims: Sequence[int]
                    ) -> torch.Tensor:
    """``t``, a local tensor, all-reduced with ``op`` ("sum", "max") over
    the mesh dims ``dims``, one collective a dim, and waited for; ``t``
    itself where ``dims`` is empty.  funcol's collectives record no graph:
    a body that differentiates through one runs it inside an
    ``autograd.Function`` (``models.layers``, ``models.losses``)."""
    from torch.distributed import _functional_collectives as funcol

    for m in dims:
        t = funcol.all_reduce(t, op, (mesh, m))
    return funcol.wait_tensor(t) if dims else t


# ---------------------------------------------------------------------------
# kernels on local shards
# ---------------------------------------------------------------------------
_SPLIT: contextvars.ContextVar[int | None] = contextvars.ContextVar(
    "repro_torch_local_split", default=None)


def local_split() -> int | None:
    """Inside the body of ``on_local_shards``, forward or backward: into how
    many distinct pieces the mesh splits the body's work (the product of
    the sizes of the mesh dims that shard one of its inputs; the ranks
    along any other mesh dim repeat it); None outside a body.  A counter of
    the world's work scales a body's local FLOPs by it (``launch.dryrun``)."""
    return _SPLIT.get()


class _OnLocalShards(torch.autograd.Function):
    """``fn`` on the local shards of DTensors, its outputs wrapped as
    DTensors.  Where a graph is recorded, ``fn`` records its own graph on
    the local tensors (the kernels' ``autograd.Function``s inside it), and
    the backward differentiates that graph and wraps each input's grad: a
    shard where the input is sharded, a ``Partial`` sum where it is
    replicated over a mesh dim that splits the work (each rank's grad
    covers its own piece), replicated elsewhere.  An output laid out as a
    ``Partial`` sum (each rank's piece of a product, ``models.layers``'
    MoE combine) takes its grad replicated: the cotangent of a sum.

    The local graph rides on an empty tensor saved for the backward (its
    ``local_graph`` attribute), so that a recomputed region
    (``torch.utils.checkpoint``, the models' remat) drops it with the
    region's other saved tensors and hands the backward the graph its
    recompute recorded; the backward's own ``autograd.grad`` then finds
    its saved tensors in place and recomputes nothing a second time."""

    @staticmethod
    def forward(ctx, fn, mesh, out_pls, split_dims, partial_grads, *xs):
        from torch.distributed.tensor import DTensor

        split = math.prod(mesh.size(m) for m in split_dims)
        need = ctx.needs_input_grad[5:]
        token = _SPLIT.set(split)
        try:
            with torch.enable_grad() if any(need) else \
                    contextlib.nullcontext():
                ins = [x.to_local().detach().requires_grad_(n)
                       for x, n in zip(xs, need)]
                outs = fn(*ins)
        finally:
            _SPLIT.reset(token)
        outs = (outs,) if isinstance(outs, torch.Tensor) else tuple(outs)
        if any(need):
            # an output no loss reads (the SSD's final state in a train
            # step) takes no grad: None, where a zero would be a plain tensor
            ctx.set_materialize_grads(False)
            ctx.mesh, ctx.out_pls, ctx.split = mesh, out_pls, split
            ctx.kept = () if not partial_grads else tuple(
                m for m in range(mesh.ndim) if m not in split_dims)
            graph = ins[0].new_empty(0)
            graph.local_graph = ins, outs
            ctx.save_for_backward(graph)
            ctx.grad_pls = [_grad_placements(x.placements, split_dims)
                            for x in xs]
        return tuple(DTensor.from_local(o.detach(), mesh, pls,
                                        run_check=False)
                     for o, pls in zip(outs, out_pls))

    @staticmethod
    def backward(ctx, *grads):
        from torch.distributed.tensor import DTensor, Partial

        ins, outs = ctx.saved_tensors[0].local_graph
        live = [(o, g, pls) for o, g, pls in zip(outs, grads, ctx.out_pls)
                if g is not None and o.requires_grad]
        # the mesh dims over which every cotangent stays a sum of parts
        kept = [m for m in ctx.kept if all(
            pls[m].is_replicate() and g.placements[m].is_partial() and
            g.placements[m].reduce_op == "sum" for _, g, pls in live)]
        pairs = [(o, g.redistribute(ctx.mesh, [
            g.placements[m] if m in kept else p for m, p in enumerate(
                _cotangent_placements(pls))]).to_local())
                 for o, g, pls in live]
        want = [x for x in ins if x.requires_grad]
        token = _SPLIT.set(ctx.split)
        try:
            got = iter(torch.autograd.grad([o for o, _ in pairs], want,
                                           [g for _, g in pairs],
                                           allow_unused=True))
        finally:
            _SPLIT.reset(token)
        out = []
        for x, pls in zip(ins, ctx.grad_pls):
            pls = [Partial() if m in kept else p for m, p in enumerate(pls)]
            g = next(got) if x.requires_grad else None
            # contiguous, as DTensor's local views in the backward need
            out.append(None if g is None else DTensor.from_local(
                g.contiguous(), ctx.mesh, pls, run_check=False))
        return (None, None, None, None, None, *out)


def _cotangent_placements(pls: Sequence) -> tuple:
    """The placements an output's grad takes into the body's backward: the
    output's own, but ``Replicate`` where it is a ``Partial`` sum across
    ranks, whose cotangent on every rank is the whole sum's (DTensor
    cannot redistribute to ``Partial``)."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() if p.is_partial() else p for p in pls)


def _grad_placements(pls: Sequence, split_dims: Sequence[int]) -> tuple:
    from torch.distributed.tensor import Partial, Replicate

    return tuple(p if is_shard(p) else
                 Partial() if m in split_dims else Replicate()
                 for m, p in enumerate(pls))


def on_local_shards(fn, inputs: Sequence[tuple], out_placements: Sequence,
                    partial_grads: bool = False) -> tuple:
    """``fn`` run on each rank's local shards: ``inputs`` are (DTensor,
    placements) pairs, each DTensor redistributed to its placements first
    (its grad back to its own in the backward); ``fn`` takes the local
    tensors and returns one local tensor or a tuple, and each output is
    wrapped as a DTensor of the matching entry of ``out_placements``.
    Returns a tuple of DTensors.  This is how a kernel, which takes plain
    tensors, runs under a mesh: the same body takes the CUDA kernels on the
    card and the plain versions elsewhere (``kernels.ops``).

    With ``partial_grads`` a replicated output's grad that comes as a
    ``Partial`` sum over a mesh dim that splits no input (on every output
    that takes one) is not reduced: the body's backward, linear in its
    cotangents, runs on each rank's part, and each input's grad is handed
    on as a ``Partial`` sum there, for a reduction that the caller places
    (``mamba2._ssd_sharded``: the chunks' C . B products)."""
    xs = []
    for x, pls in inputs:
        pls = tuple(pls)
        xs.append(x if tuple(x.placements) == pls else
                  x.redistribute(x.device_mesh, pls))
    mesh = xs[0].device_mesh
    split_dims = tuple(m for m in range(mesh.ndim)
                       if any(is_shard(x.placements[m]) for x in xs))
    return _OnLocalShards.apply(fn, mesh, tuple(map(tuple, out_placements)),
                                split_dims, partial_grads, *xs)


# ---------------------------------------------------------------------------
# column blocks of a fused projection (in_proj -> z, x, B, C, dt)
# ---------------------------------------------------------------------------
def act_mesh_dim(name: str, like: torch.Tensor) -> int | None:
    """The mesh dim that the logical activation axis ``name`` shards over
    (the first axis of its rule larger than 1) where ``like`` is a DTensor
    under a mesh context; None elsewhere."""
    if not is_sharded(like):
        return None
    ctx, names = current_ctx(), list(like.device_mesh.mesh_dim_names)
    for ax in ctx.rules.get(name, ()):
        if ax in names and ctx.axis_size(ax) > 1:
            return names.index(ax)
    return None


def _with_placement(t: torch.Tensor, mesh_dim: int, pl) -> torch.Tensor:
    """DTensor ``t`` redistributed to ``pl`` on ``mesh_dim``, its other
    placements kept, its local shard contiguous (``_Constrain``'s reason)."""
    pls = list(t.placements)
    if pls[mesh_dim] == pl:
        return t
    pls[mesh_dim] = pl
    return t.redistribute(t.device_mesh, pls).contiguous()


def whole_over(t: torch.Tensor, mesh_dim: int) -> torch.Tensor:
    """DTensor ``t`` replicated over ``mesh_dim``, its other placements
    kept: gathered where it is split there, its grad then reduced to t's
    shard in one closed form (``_Gathered``)."""
    from torch.distributed.tensor import Replicate

    if is_shard(t.placements[mesh_dim]):
        return _Gathered.apply(t, mesh_dim)
    return _with_placement(t, mesh_dim, Replicate())


def shard_last_over(t: torch.Tensor, mesh_dim: int) -> torch.Tensor:
    """DTensor ``t`` with its last dim split over ``mesh_dim``, its other
    placements kept: each rank's piece of a replicated ``t``, no collective."""
    from torch.distributed.tensor import Shard

    return _with_placement(t, mesh_dim, Shard(t.ndim - 1))


class _WeightBlocks(torch.autograd.Function):
    """The column blocks (offset, width) ``spans`` of a weight DTensor
    ``w`` whose last dim is split evenly over ``mesh_dim`` or whole there.
    Forward: ``w`` gathered over ``mesh_dim`` (a weight, small beside what
    its product makes), each block of ``split`` cut to this rank's
    contiguous piece of it, split over ``mesh_dim`` (``Shard`` of the last
    dim), each other block whole there; with ``joined`` the split blocks
    come first as one DTensor, block after block, as Megatron lays out a
    fused QKV (a product by it splits into the blocks' shards with no
    collective: ``split_blocked``), then the others.

    Backward, on local shards, in one closed form: every block's grad
    (a whole block's cut to the columns of w's own shard) joined into one
    local tensor, which takes w's placements on the other mesh dims by one
    collective a dim (``_onto``: one reduce-scatter over ``data`` for an
    FSDP weight); then over ``mesh_dim`` the split blocks' columns go back
    to w's own column order by one all-to-all (``_exchange``), or are
    all-gathered where w is whole there.  The grad is never gathered
    whole over ``mesh_dim`` where w is split there."""

    @staticmethod
    def forward(ctx, w, spans, split, mesh_dim, joined):
        from torch.distributed.tensor import DTensor, Replicate, Shard

        mesh, pls = w.device_mesh, tuple(w.placements)
        T, r = mesh.size(mesh_dim), mesh.get_coordinate()[mesh_dim]
        whole = list(pls)
        whole[mesh_dim] = Replicate()
        cut = list(whole)
        cut[mesh_dim] = Shard(w.ndim - 1)
        local = w.redistribute(mesh, whole).to_local()

        def out(t, pls, n):
            shape = (*w.shape[:-1], n)
            return DTensor.from_local(
                t.contiguous(), mesh, pls, run_check=False,
                shape=torch.Size(shape), stride=_global_stride(shape))

        pieces = [local[..., o + r * n // T:o + (r + 1) * n // T]
                  for (o, n), s in zip(spans, split) if s]
        outs, entries = [], []   # entries: ("cut", width) or ("whole", span)
        if joined and pieces:
            n = sum(n for (_, n), s in zip(spans, split) if s)
            outs.append(out(torch.cat(pieces, dim=-1), cut, n))
            entries.append(("cut", n))
        it = iter(pieces)
        for (o, n), s in zip(spans, split):
            if not s:
                outs.append(out(local[..., o:o + n], whole, n))
                entries.append(("whole", (o, n)))
            elif not joined:
                outs.append(out(next(it), cut, n))
                entries.append(("cut", n))
        ctx.plan = (mesh, pls, tuple((o, n) for (o, n), s in zip(spans, split)
                                     if s), mesh_dim, w.shape, entries)
        return tuple(outs)   # an unused block's grad comes as zeros

    @staticmethod
    def backward(ctx, *grads):
        from torch.distributed import _functional_collectives as funcol
        from torch.distributed.tensor import DTensor, Replicate, Shard

        mesh, pls, cut, m, shape, entries = ctx.plan
        T, r, last, d = mesh.size(m), mesh.get_coordinate()[m], \
            len(shape) - 1, shape[-1]
        # the grads' placements on the mesh dims but m: the first's (a
        # product's by rows split over data: a Partial sum there)
        ref = list(grads[0].placements)
        lo, hi = (r * d // T, (r + 1) * d // T) if is_shard(pls[m]) \
            else (0, d)
        # the split blocks' local grads in order, then the whole blocks'
        # columns in [lo, hi)
        cuts, wholes, whole_cols = [], [], []
        for g, (kind, what) in zip(grads, entries):
            on_m = Shard(last) if kind == "cut" else Replicate()
            want = [on_m if k == m else p for k, p in enumerate(ref)]
            if list(g.placements) != want:
                g = g.redistribute(mesh, want)
            if kind == "cut":
                cuts.append(g.to_local())
                continue
            o, n = what
            a, b = max(o, lo), min(o + n, hi)
            if a < b:
                wholes.append(g.to_local()[..., a - o:b - o])
                whole_cols += range(a, b)
        buf = torch.cat(cuts + wholes, dim=-1).contiguous()
        # one reduction over the other mesh dims, every block at once
        on = [Replicate() if k == m else p for k, p in enumerate(ref)]
        full = list(buf.shape)
        for k, p in enumerate(on):
            if is_shard(p):
                full[p.dim] *= mesh.size(k)
        buf = _onto(DTensor.from_local(
            buf, mesh, on, run_check=False, shape=torch.Size(full),
            stride=_global_stride(full)),
            [Replicate() if k == m else p for k, p in enumerate(pls)])
        n_cut = sum(n // T for _, n in cut)
        got, at = buf[..., :n_cut], []
        if cut:
            dst, mine = _layouts(cut, d, T)
            if is_shard(pls[m]):
                got = _exchange(got, _exchange_plan(mine, dst, r), mesh, m)
                at = list(dst[r])
            else:
                got = funcol.wait_tensor(funcol.all_gather_tensor(
                    got.contiguous(), last, (mesh, m)))
                at = [c for k in range(T) for c in mine[k]]
        # every column of the shard, where a block holds it
        out = buf.new_zeros(*buf.shape[:-1], hi - lo)
        out.index_copy_(last, torch.tensor(
            [c - lo for c in at + whole_cols], dtype=torch.long,
            device=out.device), torch.cat([got, buf[..., n_cut:]], dim=-1))
        return (DTensor.from_local(out, mesh, pls, run_check=False,
                                   shape=shape,
                                   stride=_global_stride(shape)),
                None, None, None, None)


def weight_blocks(w: torch.Tensor, spans: Sequence[tuple[int, int]],
                  split: Sequence[bool], mesh_dim: int,
                  joined: bool = False) -> tuple:
    """The column blocks (offset, width) ``spans`` of weight DTensor ``w``
    (``_WeightBlocks``): a block of ``split`` split over ``mesh_dim``, each
    rank its contiguous piece (every such width must divide by the mesh
    dim's size), any other whole there; with ``joined`` the split blocks as
    one DTensor, then the others.  Gathered over ``mesh_dim`` as a bare
    redistribution would; its grad reduced to w's placements in one closed
    form, never gathered whole over ``mesh_dim``."""
    return _WeightBlocks.apply(w, tuple(map(tuple, spans)), tuple(split),
                               mesh_dim, joined)


class _SplitBlocked(torch.autograd.Function):
    """The blocks of a DTensor whose last dim is split over ``mesh_dim``
    in ``weight_blocks``' joined order: each a DTensor of its own width
    split the same way, cut from the local shard (contiguous copies;
    nothing is saved).  Backward: the blocks' grads, laid out as their
    outputs, are joined on each rank."""

    @staticmethod
    def forward(ctx, x, widths, mesh_dim):
        from torch.distributed.tensor import DTensor

        mesh, pls = x.device_mesh, tuple(x.placements)
        T = mesh.size(mesh_dim)
        local = x.to_local()
        ctx.mesh, ctx.pls, ctx.shape = mesh, pls, x.shape
        ctx.dtype, ctx.device = local.dtype, local.device
        ctx.local_shapes, outs, o = [], [], 0
        for n in widths:
            piece = local.narrow(-1, o, n // T).contiguous()
            o += n // T
            shape = (*x.shape[:-1], n)
            ctx.local_shapes.append(piece.shape)
            outs.append(DTensor.from_local(
                piece, mesh, pls, run_check=False, shape=torch.Size(shape),
                stride=_global_stride(shape)))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        from torch.distributed.tensor import DTensor

        parts = [g.redistribute(ctx.mesh, ctx.pls).to_local()
                 if g is not None else
                 torch.zeros(s, dtype=ctx.dtype, device=ctx.device)
                 for g, s in zip(grads, ctx.local_shapes)]
        return DTensor.from_local(
            torch.cat(parts, dim=-1), ctx.mesh, ctx.pls, run_check=False,
            shape=ctx.shape, stride=_global_stride(ctx.shape)), None, None


def split_blocked(x: torch.Tensor, widths: Sequence[int], mesh_dim: int
                  ) -> tuple:
    """The blocks of ``widths`` of DTensor ``x``, whose last dim holds them
    in ``weight_blocks``' joined order split over ``mesh_dim``: each block a
    DTensor split there too, with no collective.  ``x`` is first taken to
    that layout (nothing moves where it is in it, as after a product by
    ``weight_blocks``' joined weight)."""
    return _SplitBlocked.apply(shard_last_over(x, mesh_dim), tuple(widths),
                               mesh_dim)


@functools.cache
def _exchange_plan(src: tuple, dst: tuple, rank: int) -> tuple:
    """How rank ``rank`` takes a tensor's last dim from layout ``src`` to
    ``dst`` (each a tuple, a rank, of the global columns it holds, in
    order) by one all-to-all: (the local columns to send, in order, and how
    many go to each rank; how many come from each rank; the order that
    puts what came, concatenated, into ``dst[rank]``'s).  A rank sends each
    other rank the columns that both hold, in the order the receiver keeps
    them."""
    pos = {c: i for i, c in enumerate(src[rank])}
    send, send_n = [], []
    for cols in dst:
        got = [pos[c] for c in cols if c in pos]
        send += got
        send_n.append(len(got))
    mine = {c: i for i, c in enumerate(dst[rank])}
    came, recv_n = [], []
    for cols in src:
        got = sorted(mine[c] for c in cols if c in mine)
        came += got
        recv_n.append(len(got))
    order = sorted(range(len(came)), key=came.__getitem__)
    return tuple(send), tuple(send_n), tuple(recv_n), tuple(order)


@functools.cache
def _layouts(spans: tuple, d: int, T: int) -> tuple[tuple, tuple]:
    """(natural, blocked): a rank each, the global columns of the blocks
    ``spans`` (offset, width) that its shard holds, in order: of the
    ``d`` columns split in T equal pieces whole, or of each block's T
    pieces, block after block (``weight_blocks``' joined order)."""
    cols = {c for o, n in spans for c in range(o, o + n)}
    natural = tuple(tuple(c for c in range(r * d // T, (r + 1) * d // T)
                          if c in cols) for r in range(T))
    blocked = tuple(tuple(c for o, n in spans
                          for c in range(o + r * n // T,
                                         o + (r + 1) * n // T))
                    for r in range(T))
    return natural, blocked


def _spans(widths: Sequence[int]) -> tuple:
    """The (offset, width) of blocks of ``widths`` laid end to end."""
    return tuple((sum(widths[:i]), n) for i, n in enumerate(widths))


def _exchange(local: torch.Tensor, plan: tuple, mesh, mesh_dim: int
              ) -> torch.Tensor:
    """``local``'s last dim taken to another layout by ``plan``
    (``_exchange_plan``'s), one all-to-all over ``mesh_dim``; the grad
    flows back the same way."""
    from torch.distributed import _functional_collectives as funcol

    send, send_n, recv_n, order = plan
    dev = local.device
    buf = local.movedim(-1, 0).index_select(
        0, torch.tensor(send, dtype=torch.long, device=dev)).contiguous()
    got = funcol.wait_tensor(funcol.all_to_all_single_autograd(
        buf, list(recv_n), list(send_n), (mesh, mesh_dim)))
    return got.index_select(0, torch.tensor(
        order, dtype=torch.long, device=dev)).movedim(0, -1)


def to_blocks(x: torch.Tensor, widths: Sequence[int], mesh_dim: int
              ) -> tuple:
    """DTensor ``x``'s last dim, the blocks of ``widths`` concatenated, as
    the blocks: each split over ``mesh_dim`` where ``x`` is split there in
    T equal pieces whole, by one all-to-all of a rank's shard and no
    gather; each block replicated there where ``x`` is, or where a width
    does not divide by T (``x`` is then gathered)."""
    T = x.device_mesh.size(mesh_dim)
    spans = _spans(widths)
    pls = tuple(x.placements)
    if not is_shard(pls[mesh_dim]) or any(n % T for n in widths):
        x = whole_over(x, mesh_dim)
        return tuple(x[..., o:o + n] for o, n in spans)
    natural, blocked = _layouts(spans, sum(widths), T)
    r = x.device_mesh.get_coordinate()[mesh_dim]
    plan = _exchange_plan(natural, blocked, r)
    mesh = x.device_mesh

    def body(local):
        out = _exchange(local, plan, mesh, mesh_dim)
        return tuple(out.narrow(-1, o // T, n // T).contiguous()
                     for o, n in spans)

    return on_local_shards(body, [(x, pls)], [pls] * len(widths))


def from_blocks(blocks: Sequence[torch.Tensor], mesh_dim: int
                ) -> torch.Tensor:
    """The inverse of ``to_blocks``: DTensors split alike over
    ``mesh_dim`` on their last dims concatenated there, the result split
    over ``mesh_dim`` in T equal pieces, by one all-to-all of a rank's
    pieces and no gather.  Where a block is replicated over ``mesh_dim``
    the blocks are concatenated whole (each gathered)."""
    first = blocks[0]
    pls = tuple(first.placements)
    if not all(is_shard(b.placements[mesh_dim]) for b in blocks):
        return torch.cat([whole_over(b, mesh_dim) for b in blocks], dim=-1)
    mesh, T = first.device_mesh, first.device_mesh.size(mesh_dim)
    widths = [b.shape[-1] for b in blocks]
    natural, blocked = _layouts(_spans(widths), sum(widths), T)
    plan = _exchange_plan(blocked, natural, mesh.get_coordinate()[mesh_dim])

    def body(*locals_):
        return _exchange(torch.cat(locals_, dim=-1), plan, mesh, mesh_dim)

    return on_local_shards(body, [(b, pls) for b in blocks], [pls])[0]


def write_slots(cache: torch.Tensor, value: torch.Tensor, start: int,
                layer: int | None = None) -> None:
    """Write ``value`` (B, H, n, D) into slots ``start`` .. ``start + n - 1``
    of ``cache`` ([L,] B, H, S, D), at ``layer`` where given, in place.  On
    a DTensor cache each rank writes the slots of its own shard that the
    range covers, and no slot moves: the value takes the cache's batch and
    head layout and is replicated over the mesh dims that split the slots
    (a redistribution of the value alone).  JAX's ``dynamic_update_slice``
    keeps the shards in place the same way."""
    idx = () if layer is None else (layer,)
    n = value.shape[2]
    if not is_sharded(cache):
        cache[idx + (slice(None), slice(None), slice(start, start + n))] = \
            value
        return
    from torch.distributed.tensor import Replicate, Shard

    lead, mesh = len(idx), cache.device_mesh
    pls = [Shard(p.dim - lead) if type(p) is Shard and p.dim - lead in (0, 1)
           else Replicate() for p in cache.placements]
    local_v = replicate_as(value, cache).redistribute(mesh, pls).to_local()
    lo, hi = shard_bounds(cache.shape, mesh, cache.placements, lead + 2)
    a, b = max(start, lo), min(start + n, hi)
    if a < b:
        local = cache.to_local()
        local[idx + (slice(None), slice(None), slice(a - lo, b - lo))] = \
            local_v[:, :, a - start:b - start]


def roll(t: torch.Tensor, shifts: int, dim: int) -> torch.Tensor:
    """``torch.roll(t, shifts, dims=dim)``; on a DTensor whose ``dim`` no
    mesh dim splits, each rank rolls its own shard (``on_local_shards``):
    DTensor 2.11 has no rule for ``roll``."""
    if not is_sharded(t) or any(is_shard(p) and p.dim == dim
                                for p in t.placements):
        return torch.roll(t, shifts, dims=dim)
    pls = tuple(t.placements)
    return on_local_shards(lambda x: torch.roll(x, shifts, dims=dim),
                           [(t, pls)], [pls])[0]


def roll_slots(cache: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.roll(cache, -1, dims=dim)``: the slots shift left by one and
    the first comes last.  Where a DTensor's ``dim`` is sharded, each rank
    shifts its own shard and takes the next shard's first slot from its
    owner: one permute of a slot's worth a rank for each mesh dim that
    splits the slots, innermost first, where DTensor's own roll would
    gather the whole dim."""
    if not is_sharded(cache):
        return torch.roll(cache, -1, dims=dim)
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Shard

    mesh, pls = cache.device_mesh, tuple(cache.placements)
    slot_dims = [m for m, p in enumerate(pls) if is_shard(p) and p.dim == dim]
    if not slot_dims:
        return roll(cache, -1, dim)
    if any(type(pls[m]) is not Shard for m in slot_dims):
        raise NotImplementedError(f"dim {dim} split by a strided shard")
    coord = mesh.get_coordinate()

    def body(local):
        need = local.narrow(dim, 0, 1).contiguous()
        update = True  # whether every inner slot dim's coordinate is last
        for m in reversed(slot_dims):
            n = mesh.size(m)
            got = funcol.permute_tensor(need.flatten(), [
                (i - 1) % n for i in range(n)], (mesh, m)).view_as(need)
            if update:
                need = got
            update = update and coord[m] == n - 1
        return torch.cat([local.narrow(dim, 1, local.shape[dim] - 1), need],
                         dim=dim)

    return on_local_shards(body, [(cache, pls)], [pls])[0]


def shift_in(cache: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """A rolling cache (B, H, S, D) shifted left one slot, ``value`` (B, H,
    1, D) in the last: ``cat([cache[:, :, 1:], value])``, or on a DTensor
    ``roll_slots`` and ``write_slots``, which keep the slots' shards."""
    if not is_sharded(cache):
        return torch.cat([cache[:, :, 1:], value], dim=2)
    out = roll_slots(cache, 2)
    write_slots(out, value, cache.shape[2] - 1)
    return out


def place(t: torch.Tensor, names: Sequence[str | None]) -> torch.Tensor:
    """``t``, a whole tensor that every rank holds alike, as a DTensor laid
    out by its logical ``names`` under the context's mesh (each rank keeps
    its own shard, nothing is sent); ``t`` unchanged outside a mesh."""
    sharding = logical_sharding(t.shape, names)
    if sharding is None:
        return t
    from torch.distributed.tensor import distribute_tensor

    mesh, pls = sharding
    return distribute_tensor(t, mesh, pls, src_data_rank=None)


def pad_to_multiple(n: int, multiple: int) -> int:
    """Round up (used for vocab padding so TP divides: paper-of-record
    practice for odd vocab sizes like 92553)."""
    return int(math.ceil(n / multiple) * multiple)


def operand_footprint(nbytes: float, shard_index: int, n_clusters: int,
                      sticky: bool = False):
    """Training-side :class:`~repro_torch.core.dag.DataFootprint` for a
    shard-local operand: shard ``i`` of an FSDP/TP layout lives on cluster
    ``i % n_clusters`` (``home``, so residency survives
    ``reset_execution_state``).  ``sticky=False`` by default: optimizer
    re-sharding may migrate an operand, unlike a serving KV cache."""
    from ..core.dag import DataFootprint

    if n_clusters <= 0:
        raise ValueError(f"n_clusters must be positive, got {n_clusters}")
    return DataFootprint(nbytes=nbytes, sticky=sticky,
                         home=shard_index % n_clusters)
