"""Fault-tolerant checkpointing (pure numpy + JSON).  Twin of
``repro.checkpointing.checkpoint``, in its layout, so that a checkpoint
written by either package restores in the other::

    <dir>/step_000100/
        MANIFEST.json      # tree structure, shapes, dtypes, status=COMPLETE
        leaf_00000.npy     # one file per leaf
        ...

A tree is dicts and dataclasses (``AdamWState``) over tensors.  Leaves are
ordered, and their paths spelled, as ``jax.tree_util`` orders and spells
them: a dict's keys sorted (``['opt']``), a dataclass's fields in
declaration order (``.mu``), joined by ``/``.  A bf16 leaf is stored as its
``uint16`` bits, which needs no ``ml_dtypes`` on either side.

Restart protocol: ``CheckpointManager.latest()`` scans for the highest step
whose manifest says COMPLETE, so a half-written checkpoint (a node that died
mid-save) is ignored.  ``async_save`` copies the tree to host memory and
writes it on a background thread; the manager joins the writer before the
next save (single-writer rule).
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import re
import shutil
import threading
import time
from typing import Any, NamedTuple

import numpy as np
import torch


class Template(NamedTuple):
    """A leaf of a restore template: what the restored tensor must be."""

    shape: tuple
    dtype: torch.dtype
    device: Any = "cpu"


def _is_leaf(node) -> bool:
    return isinstance(node, (torch.Tensor, Template))


def _children(node) -> list[tuple[str, Any]]:
    """(path entry, child) of a dict or dataclass node, in JAX's order."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f".{f.name}", getattr(node, f.name))
                for f in dataclasses.fields(node)]
    raise TypeError(f"checkpoint trees hold dicts, dataclasses and tensors, "
                    f"got {type(node).__name__}")


def _flatten_with_paths(tree: Any) -> tuple[list[str], list]:
    if _is_leaf(tree):
        return [""], [tree]
    paths, leaves = [], []
    for entry, child in _children(tree):
        sub_paths, sub_leaves = _flatten_with_paths(child)
        paths += [entry + ("/" + p if p else "") for p in sub_paths]
        leaves += sub_leaves
    return paths, leaves


def _unflatten(like: Any, leaves) -> Any:
    """``like``'s structure with its leaves taken in turn from ``leaves``
    (an iterator)."""
    if _is_leaf(like):
        return next(leaves)
    if isinstance(like, dict):
        built = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: built[k] for k in like}
    return dataclasses.replace(like, **{
        entry[1:]: _unflatten(child, leaves)
        for entry, child in _children(like)})


def _treedef(tree: Any) -> str:
    """The structure as ``str(jax.tree_util.tree_structure(tree))`` prints
    it for the same tree."""
    def spell(node):
        if _is_leaf(node):
            return "*"
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {spell(node[k])}"
                                   for k in sorted(node)) + "}"
        kids = ", ".join(spell(child) for _, child in _children(node))
        return f"CustomNode({type(node).__name__}[()], [{kids}])"
    return f"PyTreeDef({spell(tree)})"


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _to_numpy(leaf: torch.Tensor) -> np.ndarray:
    """The leaf's bytes on the host; bf16 as its uint16 bits."""
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(raw: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(raw)


def save_checkpoint(directory: str | pathlib.Path, step: int, tree: Any
                    ) -> pathlib.Path:
    directory = pathlib.Path(directory)
    final = directory / f"step_{step:08d}"
    tmp = directory / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    paths, leaves = _flatten_with_paths(tree)
    manifest = {
        "step": step,
        "status": "WRITING",
        "treedef": _treedef(tree),
        "leaves": [],
        "written_at": time.time(),
    }
    for i, (path, leaf) in enumerate(zip(paths, leaves)):
        np.save(tmp / f"leaf_{i:05d}.npy", _to_numpy(leaf))
        manifest["leaves"].append(
            {"index": i, "path": path, "shape": list(leaf.shape),
             "dtype": _dtype_name(leaf.dtype)})
    manifest["status"] = "COMPLETE"
    (tmp / "MANIFEST.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic publish
    return final


def load_checkpoint(directory: str | pathlib.Path, step: int,
                    like: Any) -> Any:
    """Restore into the structure of ``like``, a tree of tensors or
    ``Template``s: each leaf in its template's dtype, on its device."""
    d = pathlib.Path(directory) / f"step_{step:08d}"
    manifest = json.loads((d / "MANIFEST.json").read_text())
    if manifest["status"] != "COMPLETE":
        raise ValueError(f"checkpoint at {d} is incomplete")
    leaves = [_from_numpy(np.load(d / f"leaf_{e['index']:05d}.npy"),
                          e["dtype"]) for e in manifest["leaves"]]
    _, like_leaves = _flatten_with_paths(like)
    if len(like_leaves) != len(leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves, template has "
            f"{len(like_leaves)}")
    out = []
    for tmpl, arr in zip(like_leaves, leaves):
        if tuple(tmpl.shape) != tuple(arr.shape):
            raise ValueError(f"shape mismatch {tuple(tmpl.shape)} vs "
                             f"{tuple(arr.shape)}")
        out.append(arr.to(device=tmpl.device, dtype=tmpl.dtype))
    return _unflatten(like, iter(out))


class CheckpointManager:
    """Rolling checkpoints with async save and restart discovery."""

    STEP_RE = re.compile(r"step_(\d+)$")

    def __init__(self, directory: str | pathlib.Path, keep: int = 3):
        self.directory = pathlib.Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._writer: threading.Thread | None = None

    # -- discovery -----------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for p in self.directory.iterdir():
            m = self.STEP_RE.search(p.name)
            if not m:
                continue
            try:
                manifest = json.loads((p / "MANIFEST.json").read_text())
            except (FileNotFoundError, json.JSONDecodeError):
                continue
            if manifest.get("status") == "COMPLETE":
                out.append(int(m.group(1)))
        return sorted(out)

    def latest(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    # -- saving ----------------------------------------------------------------
    def wait(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None

    def save(self, step: int, tree: Any) -> None:
        self.wait()
        save_checkpoint(self.directory, step, tree)
        self._gc()

    def async_save(self, step: int, tree: Any) -> None:
        """Snapshot to host memory synchronously, write to disk on a thread."""
        self.wait()
        _, leaves = _flatten_with_paths(tree)
        host_tree = _unflatten(tree, iter([leaf.detach().to("cpu", copy=True)
                                           for leaf in leaves]))

        def _write():
            save_checkpoint(self.directory, step, host_tree)
            self._gc()

        self._writer = threading.Thread(target=_write, daemon=True)
        self._writer.start()

    def restore(self, like: Any, step: int | None = None) -> tuple[int, Any]:
        step = step if step is not None else self.latest()
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {self.directory}")
        return step, load_checkpoint(self.directory, step, like)

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self.directory / f"step_{s:08d}", ignore_errors=True)
