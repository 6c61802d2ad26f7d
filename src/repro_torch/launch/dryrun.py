"""Multi-pod dry run of the port.  Twin of ``repro.launch.dryrun``.

For every (architecture x input shape) cell, run the production step once
on the 16x16 single-pod mesh (256 ranks) and the 2x16x16 multi-pod mesh
(512 ranks) over stand-ins that allocate nothing, and record per cell:

  * ``matmul_flops``            -- the step's matmul FLOPs over the world
  * ``matmul_flops_per_device`` -- the same counted on one rank's shards
  * ``collectives``             -- bytes per device a collective kind
  * ``memory``                  -- per-device bytes of the step's arguments
                                   and the peak of what the step allocates

The world is torch's ``fake`` process group (``mesh.fake_world``), started
for each mesh and destroyed after it; every tensor lives on the meta device,
a DTensor with the placements of its logical names.  The dry run never
initialises CUDA: it counts the program of the production meshes on any
host, as the reference lowers it on 512 fake host devices.  That is the
design, not a CPU fallback.  The hand kernels launch on CUDA tensors only,
so on meta every op takes its plain version: the counts are those of the
plain norms and of the reference's attention, dense up to
``dense_attn_max_seq`` and q-chunked above it, over every key or, under
``swa_block_skip``, over each chunk's causal and window slice of the keys
(``models.layers.attention``).

What is counted, and how it differs from the reference's numbers:

  * FLOPs come from ``torch.utils.flop_counter``'s formulas, which cover
    matmul-like ops (mm, bmm, addmm, baddbmm, attention); XLA's
    ``cost_analysis`` counts elementwise work too.  A dispatch mode sees
    each op twice: on DTensors, at global shapes (the world's FLOPs), and
    on the local shards DTensor runs them on (one device's FLOPs, redundant
    work on replicated operands included).  Without a mesh the two agree.
  * A train step recomputes each layer in its backward as the config's
    ``remat`` and ``remat_policy`` ask (``models.layers.remat``), and the
    counter counts the recompute, as the reference's cost analysis does:
    under ``"nothing"`` each layer's products again but its last, whose
    output no backward reads (torch stops the recompute there, XLA drops
    it as dead code), under ``"dots"`` the products with batch dims
    (attention's), none with ``remat=False``.
  * Collectives are the ``_c10d_functional`` ops DTensor issues to
    redistribute, each counted once at its result's bytes on the local
    shard, as the reference counts each HLO collective's result
    (``collective_bytes``).  The fake backend has no all-to-all: DTensor
    replaces one with an all-gather and a chunk on a CPU mesh.  While a
    cell runs, the dry run routes that exchange to DTensor's own
    ``shard_dim_alltoall`` op instead, so it counts as an all-to-all of
    its result's bytes, as NCCL would run it.
  * ``argument_size_bytes`` sums the local shards of the parameters, the
    optimizer state, the inputs and the cache.  ``temp_size_bytes`` is the
    peak over the step of the bytes a device holds in storages that the
    step's ops made (``StepCounter``): saved activations, transients and
    outputs, the arguments left out.  On meta the norms and attention take
    their plain versions, so a forward without remat saves what they save
    (a layer's fp32 softmax over (S, Sk), chunk by chunk above
    ``dense_attn_max_seq``, as the reference's ``lax.scan`` keeps its
    residuals), where the card's kernels keep their inputs alone; under
    remat one layer's are live at a time, as in the card's plain backward.
    A forward with no grad holds one chunk's scores at a time.  With no
    compiled program there is no generated-code or alias size and no
    lower or compile time: those keys are ``null``, never 0.
  * The reference compiles 0- and 1-layer variants of each model because
    XLA counts a scanned layer body once (``_combine_costs``,
    ``_cost_variants``).  Eager code runs every layer, so the port drops
    them; ``--no-cost-accounting`` is accepted and has no effect.

A decode cell's cache is at ``configs.decode_pos``, which the JSON records:
the port's decode reads ``pos`` on the host.  ``scan_layers``, XLA's layer
scan (``NO_EFFECT``), changes nothing in the port's eager models, which run
every layer, so ``--set`` refuses it; the attention knobs (``attn_chunk``,
``dense_attn_max_seq``, ``swa_block_skip``) are taken, as are the others.
``ce_onehot`` means on a mesh what it means in the reference
(``losses.lm_cross_entropy``): ``False``, the default, counts the
all-gather of a device's fp32 logits over the vocab, as XLA lowers the
reference's gather; ``True`` counts three all-reduces of (B, S) fp32 values
and no gather of the logits.

Results are written incrementally to ``<out>/<mesh>/<arch>__<shape>.json``
so that an interrupted sweep resumes where it left off.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
      --shape prefill_32k --single-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
      [--multi-pod | --single-pod]
"""
from __future__ import annotations

import argparse
import ast
import contextlib
import dataclasses
import json
import pathlib
import time

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..configs import (ARCH_IDS, SHAPES, SHAPE_NAMES, cell_skip_reason,
                       decode_pos, get_config, input_specs)
from ..models import (get_model, make_decode_step, make_encode_step,
                      make_prefill_step, make_train_step)
from ..optimizer import abstract_opt_state
from ..parallel.sharding import (LOGICAL_RULES, is_sharded, local_split,
                                 use_sharding)
from .mesh import fake_world, make_production_mesh, mesh_chip_count

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
MESHES = {"single_pod": False, "multi_pod": True}  # name -> multi_pod
# ModelConfig knobs that only the reference's compiled models read: XLA's
# layer scan
NO_EFFECT = ("scan_layers",)
# serve-time weight layout of decode_no_fsdp cells (dryrun.py:215-225):
# contracting dims stay local, hidden dims absorb every mesh axis
DECODE_NO_FSDP_RULES = {"embed": (), "ff": ("model", "data"),
                        "heads": ("model", "data"),
                        "kv_heads": ("model", "data"),
                        "vocab": ("model", "data")}
COST_NOTE = (
    "matmul FLOPs only (torch.utils.flop_counter: mm, bmm, addmm, baddbmm, "
    "attention); XLA's cost_analysis counts elementwise work too. "
    "matmul_flops is the world's, at global shapes; matmul_flops_per_device "
    "counts one rank's local shards: attention and the norms run on each "
    "rank's shards (q heads sharded as act_heads resolves, k and v whole "
    "where their heads do not divide the model axis), counted into the "
    "world's times the pieces the mesh splits them into. A train step's "
    "backward recomputes each layer as remat and remat_policy ask, and its "
    "FLOPs count the recompute, as the reference's do: under 'nothing' "
    "every product of a layer but its last (whose output no backward "
    "reads), under 'dots' the products with batch dims. Eager code runs "
    "every layer, so the reference's 0/1-layer "
    "accounting (an XLA scan quirk) is dropped. On a mesh the loss runs "
    "the reference's program for its ce_onehot: False all-gathers the fp32 "
    "logits over the vocab and takes the gold logit from whole rows; True "
    "reduces each rank's vocab shard and all-reduces (B, S) fp32 values "
    "(the max, the sum of exponentials, the gold logit), gathering no "
    "logits. A norm whose row the mesh splits all-reduces (B, S) sums of "
    "squares, and one more in its backward. Above dense_attn_max_seq (S a "
    "multiple of attn_chunk) the plain attention runs attn_chunk q rows at "
    "a time, as the reference's does, at the dense path's FLOPs; under "
    "swa_block_skip each chunk reads only its causal and window slice of "
    "the keys, and the FLOPs are that path's, as the reference counts "
    "them.")
MEMORY_NOTE = (
    "per-device bytes of the local shards. temp: the peak over the step of "
    "the bytes in storages the step's ops made (saved activations, "
    "transients, outputs; the arguments left out). On meta the norms and "
    "attention are plain, so a forward without remat saves what they save "
    "(a layer's fp32 softmax over (S, Sk) among it), where the card's "
    "kernels keep their inputs alone; under remat one layer's at a time, "
    "as in the card's plain backward. Above dense_attn_max_seq the plain "
    "attention runs chunk by chunk, as the reference's does: a forward "
    "with no grad holds one (B, H, attn_chunk, Sk) chunk of fp32 scores "
    "at a time, never (S, Sk). No compiled program, so no generated-code "
    "or alias size")


def _collective_kinds() -> dict:
    """OpOverloadPacket -> key of ``COLLECTIVES`` for the collectives that
    DTensor issues (``_dtensor.shard_dim_alltoall`` is defined once
    ``torch.distributed.tensor`` is imported)."""
    import torch.distributed.tensor  # noqa: F401  (defines _dtensor ops)

    c = torch.ops._c10d_functional
    return {c.all_gather_into_tensor: "all-gather",
            c.all_gather_into_tensor_coalesced: "all-gather",
            c.all_reduce: "all-reduce",
            c.all_reduce_coalesced: "all-reduce",
            c.reduce_scatter_tensor: "reduce-scatter",
            c.reduce_scatter_tensor_coalesced: "reduce-scatter",
            c.all_to_all_single: "all-to-all",
            torch.ops._dtensor.shard_dim_alltoall: "all-to-all"}


def _locals(tree):
    """Every tensor in ``tree`` (dicts, tuples, lists, dataclasses and
    tensors), a DTensor as its local shard."""
    if isinstance(tree, torch.Tensor):
        yield tree.to_local() if is_sharded(tree) else tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _locals(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _locals(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _locals(getattr(tree, f.name))


def _aliasing_wrappers() -> tuple:
    """Ops that return their input wrapped, with no copy, on a device but
    allocate a new tensor on meta: funcol's autograd wrapper of a
    collective's result (an ``AsyncCollectiveTensor`` over the same
    memory; its meta kernel is ``empty_like``).  Their outputs are not new
    bytes."""
    import torch.distributed._functional_collectives  # noqa: F401

    op = getattr(torch.ops._c10d_functional, "_wrap_tensor_autograd", None)
    return () if op is None else (op,)


def _nbytes(tree) -> int:
    """Bytes of every tensor in ``tree``, a DTensor counted at its local
    shard."""
    return sum(t.numel() * t.element_size() for t in _locals(tree))


class StepCounter(TorchDispatchMode):
    """Counts a step's matmul FLOPs and collective bytes, and the peak of
    the bytes a device holds in storages that the step's ops made.

    An op on DTensors is counted at global shapes into ``global_flops`` and
    handed on (``NotImplemented``), so DTensor runs it: the ops DTensor then
    runs on the local shards, collectives included, come back here as plain
    tensors and count into ``local_flops`` and ``collectives``.  A kernel's
    body on local shards (``parallel.sharding.on_local_shards``: the norms
    and attention under a mesh) reaches the counter as plain ops alone, in
    its forward and its backward: each counts into ``local_flops`` and,
    times the number of distinct pieces the mesh splits the body into
    (``local_split``), into ``global_flops``.  Where no op ran on a DTensor
    (no mesh), the plain ops are the world's too.  The op that DTensor runs
    on fake tensors to learn an output's shape runs uncounted.

    Memory: each plain op's outputs on a device (a rank's local shards
    under a mesh) whose storage neither ``args`` nor an earlier op holds
    add their storage's bytes to ``live_bytes``.  The storages that no
    tensor holds any more (their ``StorageWeakRef`` expired) leave it only
    where it would pass ``peak_bytes``: until then it may count some dead
    ones, so it bounds the live bytes from above, and where the bound stays
    under the peak the live bytes do too.  ``peak_bytes`` is the largest
    value of the swept sum: the step's temp.  (A weak reference keeps its
    storage's address from being reused, so a dead entry never stands for
    a new storage.)"""

    def __init__(self, args=()):
        super().__init__()
        self.global_flops = 0      # ops on DTensors, at global shapes
        self.local_flops = 0       # ops on plain tensors
        self.sharded = False       # whether any op ran on a DTensor
        self.collectives = {c: 0 for c in COLLECTIVES}
        self.collectives["count"] = 0
        self._kinds = _collective_kinds()
        self._wrappers = _aliasing_wrappers()
        self._args = {StorageWeakRef(t.untyped_storage())
                      for t in _locals(args)}
        self._live: dict = {}      # StorageWeakRef -> bytes
        self.live_bytes = self.peak_bytes = 0

    def _made(self, out, alias: bool = False, exact: bool = False) -> None:
        """Add the storages of ``out`` that ``live_bytes`` does not hold
        yet (at 0 bytes where ``out`` is an ``alias`` of the op's input, at
        the tensor's own bytes where ``exact``); where the sum passes the
        peak, drop the storages no tensor holds and raise the peak to what
        is left."""
        for t in _locals(out):
            if t.device.type == "cpu":   # host scalars (a cache's pos)
                continue
            storage = t.untyped_storage()
            ref = StorageWeakRef(storage)
            if ref not in self._live and ref not in self._args:
                self._live[ref] = 0 if alias else (
                    _nbytes(t) if exact else storage.nbytes())
                self.live_bytes += self._live[ref]
        if self.live_bytes > self.peak_bytes:
            for ref in [r for r in self._live if r.expired()]:
                self.live_bytes -= self._live.pop(ref)
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            # DTensor's sharding propagation runs the global op on fake
            # tensors for its output's shape: no work of the step
            return func(*args, **kwargs)
        packet = func._overloadpacket
        flops = flop_registry.get(packet)
        if any(issubclass(t, DTensor) for t in types):
            self.sharded = True
            if flops is not None:
                self.global_flops += int(flops(*args, **kwargs,
                                               out_val=None))
            return NotImplemented
        if flops is None:
            # a composite op (aten.matmul under inference mode) reaches a
            # mode whole: count what it decomposes into
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        # the all-to-all's meta kernel gathers the whole dim and returns a
        # slice of it: a device receives the slice's bytes alone
        self._made(out, alias=packet in self._wrappers,
                   exact=packet is torch.ops._dtensor.shard_dim_alltoall)
        if flops is not None:
            n = int(flops(*args, **kwargs, out_val=out))
            self.local_flops += n
            split = local_split()
            if split is not None:
                # a kernel's body on local shards (``on_local_shards``):
                # the world runs ``split`` distinct pieces of it
                self.global_flops += n * split
        kind = self._kinds.get(packet)
        if kind is not None:
            self.collectives[kind] += _nbytes(out)
            self.collectives["count"] += 1
        return out

    def totals(self) -> tuple[int, int]:
        """(world FLOPs, one device's FLOPs).  Where no op ran on a DTensor
        the two are one count."""
        world = self.global_flops if self.sharded else self.local_flops
        return world, self.local_flops


@contextlib.contextmanager
def native_all_to_all():
    """DTensor's shard-to-shard exchange as its ``_dtensor.
    shard_dim_alltoall`` op on every mesh (on a CPU mesh DTensor takes an
    all-gather and a chunk, since gloo has no all-to-all).  The op has a
    meta implementation, so on meta shards it gives the result's shape and
    moves nothing; restored on exit."""
    from torch.distributed.tensor import placement_types

    orig = placement_types.shard_dim_alltoall

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    placement_types.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = orig


def build_step_and_specs(cfg, shape):
    """-> (step, args, {part: args of it}): the cell's step and its
    stand-ins, split into ``params``, ``opt_state``, ``inputs`` (and
    ``cache``) for the memory record."""
    model = get_model(cfg)
    specs = input_specs(cfg, shape)
    aparams = model.abstract_params()
    if shape.kind == "train":
        aopt = abstract_opt_state(aparams)
        return make_train_step(model), (aparams, aopt, specs["batch"]), {
            "params": aparams, "opt_state": aopt, "inputs": specs["batch"]}
    if shape.kind == "prefill":
        step = make_encode_step(model) if cfg.family == "encoder" else \
            make_prefill_step(model)
        return step, (aparams, specs["batch"]), {
            "params": aparams, "inputs": specs["batch"]}
    if shape.kind == "decode":
        return make_decode_step(model), \
            (aparams, specs["tokens"], specs["cache"]), {
                "params": aparams, "inputs": specs["tokens"],
                "cache": specs["cache"]}
    raise ValueError(shape.kind)


def state_bytes(cfg) -> dict:
    """Per-device bytes of the parameters and the AdamW state of ``cfg``
    under the current sharding context (one device's whole state outside
    one): ``params``, ``opt_state``."""
    aparams = get_model(cfg).abstract_params()
    return {"params": _nbytes(aparams),
            "opt_state": _nbytes(abstract_opt_state(aparams))}


def apply_overrides(cfg, overrides: dict | None):
    """``cfg`` with ``--set`` overrides; a knob in ``NO_EFFECT`` is refused
    with its name."""
    if not overrides:
        return cfg
    bad = sorted(k for k in overrides if k in NO_EFFECT)
    if bad:
        raise ValueError(f"--set {', '.join(bad)}: no model of the port "
                         f"reads it (eager code runs every layer: there is "
                         f"no layer scan), so it would change nothing")
    return dataclasses.replace(cfg, **overrides)


def temp_bytes(fn, *args) -> int:
    """The peak bytes a device holds in storages that ``fn(*args)`` makes
    (``StepCounter``'s), ``args`` stand-ins on the meta device."""
    counter = StepCounter(args)
    with counter:
        fn(*args)
    return counter.peak_bytes


def run_cell(cfg, shape, mesh) -> dict:
    """The counts of ``cfg``'s step at ``shape`` (a ``ShapeSpec``) on
    ``mesh`` (None: one device).  A decode step of a ``decode_no_fsdp``
    model takes the serve-time weight layout."""
    rules = None
    if shape.kind == "decode" and cfg.decode_no_fsdp:
        rules = {**LOGICAL_RULES, **DECODE_NO_FSDP_RULES}
    with use_sharding(mesh, rules):
        step, args, parts = build_step_and_specs(cfg, shape)
        counter = StepCounter(args)
        t0 = time.perf_counter()
        with native_all_to_all(), counter:
            out = step(*args)
        trace_s = time.perf_counter() - t0
        memory = {f"{k}_bytes": _nbytes(v) for k, v in parts.items()}
        memory = {"argument_size_bytes": _nbytes(args), **memory,
                  "output_size_bytes": _nbytes(out),
                  "temp_size_bytes": counter.peak_bytes,
                  "generated_code_size_bytes": None,
                  "alias_size_bytes": None, "note": MEMORY_NOTE}
    world, local = counter.totals()
    result = {
        "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))
        if mesh is not None else {},
        "chips": mesh_chip_count(mesh) if mesh is not None else 1,
        "trace_s": trace_s, "lower_s": None, "compile_s": None,
        "matmul_flops": world, "matmul_flops_per_device": local,
        "collectives": counter.collectives, "memory": memory,
        "rules": "decode_no_fsdp" if rules else "logical"}
    if shape.kind == "decode":
        result["decode_pos"] = decode_pos(shape)
    return result


def dryrun_cell(arch: str, shape_name: str, mesh, *,
                cost_accounting: bool = True,
                overrides: dict | None = None) -> dict:
    """One cell's record (``run_cell``'s, or the skip and its reason);
    ``mesh`` None runs it on one device."""
    cfg = apply_overrides(get_config(arch), overrides)
    shape = SHAPES[shape_name]
    reason = cell_skip_reason(cfg, shape)
    if reason is not None:
        return {"arch": arch, "shape": shape_name, "status": "skip",
                "reason": reason}
    return {"arch": arch, "shape": shape_name, "status": "ok",
            **run_cell(cfg, shape, mesh),
            "cost_detail": {"note": COST_NOTE,
                            "no_cost_accounting": not cost_accounting}}


def parse_overrides(pairs: list[str]) -> dict:
    out = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v
    return out


def main(argv: list[str] | None = None) -> dict:
    """The CLI; returns {"ok", "skip", "fail"} counts, and exits 1 where a
    cell failed."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=SHAPE_NAMES)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="only the 2x16x16 mesh")
    ap.add_argument("--single-pod", action="store_true",
                    help="only the 16x16 mesh")
    ap.add_argument("--force", action="store_true", help="recompute cells")
    ap.add_argument("--no-cost-accounting", action="store_true",
                    help="accepted and recorded; no effect (eager code runs "
                         "every layer, so there are no 0/1-layer variants "
                         "to skip)")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="ModelConfig override, e.g. --set "
                         "swa_block_skip=True (repeatable); scan_layers "
                         "(NO_EFFECT) is refused")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    overrides = parse_overrides(args.set)
    try:
        apply_overrides(get_config(ARCH_IDS[0]), overrides)
    except (ValueError, TypeError) as e:
        ap.error(str(e))
    meshes = [name for name in MESHES
              if not (name == "single_pod" and args.multi_pod)
              and not (name == "multi_pod" and args.single_pod)]
    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPE_NAMES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    out_root = pathlib.Path(args.out)
    n = {"ok": 0, "skip": 0, "fail": 0}
    for mesh_name in meshes:
        multi = MESHES[mesh_name]
        out_dir = out_root / mesh_name
        out_dir.mkdir(parents=True, exist_ok=True)
        todo = [(a, s, out_dir / f"{a}__{s}.json") for a, s in cells]
        for arch, shape, path in todo:
            if path.exists() and not args.force:
                prev = json.loads(path.read_text())
                print(f"[cached] {mesh_name} {arch} x {shape}: "
                      f"{prev['status']}")
        todo = [c for c in todo if args.force or not c[2].exists()]
        if not todo:
            continue
        with fake_world(512 if multi else 256):
            mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
            for arch, shape, path in todo:
                print(f"[dryrun] {mesh_name} {arch} x {shape} ...",
                      flush=True)
                try:
                    res = dryrun_cell(
                        arch, shape, mesh,
                        cost_accounting=not args.no_cost_accounting,
                        overrides=overrides)
                    if overrides:
                        res["overrides"] = {k: repr(v)
                                            for k, v in overrides.items()}
                except Exception as e:  # noqa: BLE001 -- record and go on
                    res = {"arch": arch, "shape": shape, "status": "fail",
                           "error": f"{type(e).__name__}: {e}"}
                    print(f"  FAIL: {res['error']}", flush=True)
                path.write_text(json.dumps(res, indent=1))
                n[res["status"]] += 1
                if res["status"] == "ok":
                    mem = res["memory"]
                    mem_gb = (mem["argument_size_bytes"]
                              + mem["temp_size_bytes"]) / 2 ** 30
                    print(f"  ok: {res['matmul_flops']:.4e} matmul FLOPs "
                          f"(world), {res['matmul_flops_per_device']:.4e} "
                          f"a device, {res['collectives']['count']} "
                          f"collectives, mem/device ~{mem_gb:.2f} GiB "
                          f"(arguments + temp), trace "
                          f"{res['trace_s']:.2f}s", flush=True)
                elif res["status"] == "skip":
                    print(f"  skip: {res['reason']}")
    print(f"done: ok={n['ok']} skip={n['skip']} fail={n['fail']} "
          f"cuda_initialized={torch.cuda.is_initialized()}")
    if n["fail"]:
        raise SystemExit(1)
    return n


if __name__ == "__main__":
    main()
