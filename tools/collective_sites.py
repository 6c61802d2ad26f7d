#!/usr/bin/env python3
"""Which source lines of the port's models issue a dry-run cell's
collectives, and how many bytes each; and where a device's matmul FLOPs
are spent.

Runs one cell of ``repro_torch.launch.dryrun`` (meta DTensors on a fake
world, no device) with a counter that charges each collective's bytes (one
device's, as the dry run counts them) to the innermost frame under
``repro_torch/models/`` that was running when DTensor issued it.  A
collective issued by the autograd engine outside any such frame (a
backward's own redistributions) is charged to ``<backward>``; a backward
that ``models.loss_and_grads`` runs is charged to its line.  The FLOPs
are charged the same way, and every storage that a device holds at the
step's peak (``temp_size_bytes``) to the op that made it and to its
frames: the innermost under ``repro_torch/models/``, under
``repro_torch/`` and under ``torch/`` (a DTensor redistribution or a
checkpoint's own copy shows there).  With ``--by-tensor`` the collectives
are also grouped by the DTensor that each one redistributes: its global
shape and dtype, its placements before and after, and whether the
autograd engine was running a backward (``backward``; remat's recompute
runs there too) or not (``forward``); a collective that no
redistribution issued (funcol's, inside a body on local shards) is grouped
by its local shapes.  Prints the cell's totals, then the sites by bytes,
by FLOPs and at the peak (and the tensors), and writes them all as JSON
with ``--json``.

Usage:
  PYTHONPATH=src python tools/collective_sites.py --arch mamba2-780m \\
      --shape train_4k [--multi-pod] [--set remat=False] [--top 15] \\
      [--by-tensor]
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import pathlib
import sys

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_production_mesh

MODELS, PORT, TORCH = "repro_torch/models/", "repro_torch/", "/torch/"
# torch's dispatch plumbing, which every op passes: no frame of it names
# the code that asked for the op
PLUMBING = ("torch/_ops.py", "torch/utils/_python_dispatch.py",
            "torch/overrides.py", "torch/_tensor.py", "torch/_compile.py",
            "torch/_dynamo/", "torch/utils/_contextlib.py",
            "torch/distributed/tensor/_dispatch.py",
            "torch/distributed/tensor/_api.py")
# the (current, target) DTensorSpecs of the redistributions under way,
# innermost last, while ``redistributions()`` is open
SPECS: list = []


def _where(f) -> str:
    name = f.f_code.co_filename.replace("\\", "/")
    for root in (MODELS, PORT, TORCH):
        if root in name:
            name = name[name.index(root):].lstrip("/")
            break
    return f"{name}:{f.f_lineno} ({f.f_code.co_name})"


def _site() -> str:
    f = sys._getframe(2)
    while f is not None:
        if MODELS in f.f_code.co_filename.replace("\\", "/"):
            return _where(f)
        f = f.f_back
    return "<backward>"


def _origin(func) -> tuple:
    """(op, the innermost frame under ``repro_torch/models/``, under
    ``repro_torch/`` but the dry run's counter, and the innermost three of
    torch's own frames between that one and the op, dispatch plumbing left
    out) of the op ``func`` running now."""
    model = port = None
    inner = []
    f = sys._getframe(1)
    while f is not None and model is None:
        name = f.f_code.co_filename.replace("\\", "/")
        if MODELS in name:
            model = _where(f)
        elif PORT in name:
            if port is None and not name.endswith("launch/dryrun.py"):
                port = _where(f)
        elif (TORCH in name and port is None and len(inner) < 3
              and not any(p in name for p in PLUMBING)):
            inner.append(_where(f))
        f = f.f_back
    return (str(func), model or "<backward>", port or "-",
            " < ".join(inner) or "-")


def _placements(pls) -> str:
    """DTensor placements, short: ``S(d)`` a shard of dim d, ``SS(d,k)`` a
    strided one (split factor k), ``R`` replicated, ``P`` a partial sum."""
    out = []
    for p in pls:
        if p.is_partial():
            out.append("P")
        elif p.is_replicate():
            out.append("R")
        elif hasattr(p, "split_factor"):
            out.append(f"SS({p.dim},{p.split_factor})")
        else:
            out.append(f"S({p.dim})")
    return "(" + ", ".join(out) + ")"


def _phase() -> str:
    """``backward`` while the autograd engine runs a node, else
    ``forward``."""
    return "forward" if torch._C._current_autograd_node() is None \
        else "backward"


class SiteCounter(dryrun.StepCounter):
    """``StepCounter`` that also charges each collective to its site,
    ``sites[site] = [bytes, count]``, and to the DTensor it redistributes
    (``tensors[(shape, dtype, from, to, phase)] = [bytes, count]``, from
    ``SPECS`` while ``redistributions()`` is open), each device's matmul FLOPs,
    ``flops[site]``, and each storage to the op that made it, keeping
    those live at the peak (``at_peak``)."""

    def __init__(self, args=()):
        super().__init__(args)
        self.sites = collections.defaultdict(lambda: [0, 0])
        self.tensors = collections.defaultdict(lambda: [0, 0])
        self.flops = collections.Counter()
        self._func = None
        self._origins: dict = {}   # StorageWeakRef -> _origin(op)
        self.at_peak: list = []    # (StorageWeakRef, bytes) at the peak

    def _made(self, out, *how, **kw) -> None:
        held, peak = set(self._live), self.peak_bytes
        super()._made(out, *how, **kw)
        for ref in self._live.keys() - held:
            self._origins[ref] = _origin(self._func)
        if self.peak_bytes > peak:
            # raising the peak swept the dead storages out of ``_live``
            self.at_peak = [(r, n) for r, n in self._live.items() if n]

    def peak_sites(self) -> list:
        """[(bytes, storages, bytes each, origin)] of the storages live at
        the peak, grouped by origin and size, largest total first."""
        groups = collections.Counter(
            (self._origins[r], n) for r, n in self.at_peak)
        return sorted(((n * k, k, n, origin)
                       for (origin, n), k in groups.items()), reverse=True)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self._func = func
        before = dict(self.collectives)
        local = self.local_flops
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if self.collectives["count"] != before["count"]:
            moved = sum(self.collectives[k] - before[k]
                        for k in dryrun.COLLECTIVES)
            for entry in (self.sites[_site()],
                          self.tensors[self._tensor(args, out)]):
                entry[0] += moved
                entry[1] += 1
        if self.local_flops != local:
            self.flops[_site()] += self.local_flops - local
        return out


    def _tensor(self, args, out) -> tuple:
        """The key of ``tensors`` for a collective of ``args`` -> ``out``
        issued now."""
        if SPECS:
            cur, tgt = SPECS[-1]
            return (tuple(cur.shape), str(cur.tensor_meta.dtype).replace(
                "torch.", ""), _placements(cur.placements),
                _placements(tgt.placements), _phase())
        shapes = [tuple(t.shape) for t in
                  torch.utils._pytree.tree_leaves((args, out))
                  if isinstance(t, torch.Tensor)]
        return ("local " + " -> ".join(map(str, shapes)), "-", "-", "-",
                _phase())

    def by_tensor(self) -> list:
        """[{shape, dtype, from, to, phase, bytes, ops}], most bytes
        first."""
        return [{"shape": k[0], "dtype": k[1], "from": k[2], "to": k[3],
                 "phase": k[4], "bytes": b, "ops": n}
                for k, (b, n) in sorted(self.tensors.items(),
                                        key=lambda kv: -kv[1][0])]


@contextlib.contextmanager
def redistributions():
    """While open, each of DTensor's redistributions pushes its (current,
    target) specs onto ``SPECS`` while it runs."""
    import torch.distributed.tensor._dispatch as dispatch
    import torch.distributed.tensor._redistribute as redistribute

    orig = redistribute.redistribute_local_tensor

    def named(local, current_spec, target_spec, *args, **kwargs):
        SPECS.append((current_spec, target_spec))
        try:
            return orig(local, current_spec, target_spec, *args, **kwargs)
        finally:
            SPECS.pop()

    mods = (dispatch, redistribute)
    for mod in mods:
        mod.redistribute_local_tensor = named
    try:
        yield
    finally:
        for mod in mods:
            mod.redistribute_local_tensor = orig


def run_cell(cfg, shape, mesh) -> tuple:
    """``dryrun.run_cell(cfg, shape, mesh)``'s result and the
    ``SiteCounter`` that counted its step."""
    counters = []

    class Recorded(SiteCounter):
        def __init__(self, a=()):
            super().__init__(a)
            counters.append(self)

    orig, dryrun.StepCounter = dryrun.StepCounter, Recorded
    try:
        with redistributions():
            res = dryrun.run_cell(cfg, shape, mesh)
    finally:
        dryrun.StepCounter = orig
    return res, counters[-1]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 mesh (default: 16x16)")
    ap.add_argument("--set", action="append", default=[], metavar="K=V")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--json", type=pathlib.Path)
    ap.add_argument("--by-tensor", action="store_true",
                    help="print the collectives grouped by the DTensor each "
                         "redistributes")
    args = ap.parse_args(argv)

    cfg = dryrun.apply_overrides(get_config(args.arch),
                                 dryrun.parse_overrides(args.set))
    with fake_world(512 if args.multi_pod else 256):
        mesh = make_production_mesh(multi_pod=args.multi_pod,
                                    device_type="cpu")
        res, counter = run_cell(cfg, SHAPES[args.shape], mesh)
    sites, flops = counter.sites, counter.flops
    gib = 2 ** 30
    kinds = {k: v for k, v in res["collectives"].items() if k != "count"}
    mesh = "2x16x16" if args.multi_pod else "16x16"
    print(f"{args.arch} {args.shape} {mesh} {args.set}: collectives "
          f"{sum(kinds.values()) / gib} GiB in "
          f"{res['collectives']['count']} ops a device; "
          f"{ {k: v / gib for k, v in kinds.items()} } GiB; "
          f"matmul_flops {res['matmul_flops']} "
          f"({res['matmul_flops_per_device']} a device); temp "
          f"{res['memory']['temp_size_bytes']} B; trace "
          f"{res['trace_s']:.1f} s")
    for site, (b, n) in sorted(sites.items(), key=lambda kv: -kv[1][0]
                               )[:args.top]:
        print(f"  {b / gib:10.4f} GiB {n:6d} ops  {site}")
    print("  a device's matmul FLOPs by site:")
    for site, n in flops.most_common(args.top):
        print(f"  {n:22d}  {site}")
    peak = [{"bytes": b, "storages": k, "bytes_each": n, "op": o[0],
             "model": o[1], "port": o[2], "torch": o[3]}
            for b, k, n, o in counter.peak_sites()]
    print(f"  storages live at the peak "
          f"({res['memory']['temp_size_bytes']} B):")
    for p in peak[:args.top]:
        print(f"  {p['bytes']:14d} B = {p['storages']:4d} x "
              f"{p['bytes_each']:12d}  {p['op']}  {p['model']}  "
              f"{p['port']}  {p['torch']}")
    tensors = counter.by_tensor()
    if args.by_tensor:
        print("  collectives by the DTensor each redistributes (global "
              "shape, dtype, placements from -> to, phase):")
        for t in tensors[:args.top]:
            print(f"  {t['bytes'] / gib:10.4f} GiB {t['ops']:6d} ops  "
                  f"{t['shape']} {t['dtype']} {t['from']} -> {t['to']} "
                  f"{t['phase']}")
    out = {"arch": args.arch, "shape": args.shape,
           "multi_pod": args.multi_pod, "set": args.set,
           "collectives": res["collectives"],
           "matmul_flops": res["matmul_flops"],
           "matmul_flops_per_device": res["matmul_flops_per_device"],
           "temp_size_bytes": res["memory"]["temp_size_bytes"],
           "trace_s": res["trace_s"],
           "sites": {k: {"bytes": b, "ops": n}
                     for k, (b, n) in sites.items()},
           "flops_per_device_by_site": dict(flops), "at_peak": peak,
           "by_tensor": tensors}
    if args.json:
        args.json.write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
