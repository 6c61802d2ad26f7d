"""Fault L (ROADMAP.md, Queue 3): the sharded embedding lookup, a decode
step's output projection and the stacking of the SSM caches' states run in
one closed form on each rank's local shards, so that every torch release
runs the same serving program, on the CPU.

The port used to leave three placements of its serving steps to DTensor,
which filled each its own way in each torch release: ``layers.embed``
replicated the ids and looked them up in the (vocab over ``model``, M over
``data``) table as a DTensor (one release gathered the table's vocab
shard, another all-to-all'd the rows); a decode step's ``o @ wo`` (and
mamba2's ``y @ out_proj``, hymba's fused ``wo``) was a partial sum over
``model`` that one release reduce-scattered and all-reduced, another
all-reduced once; and ``mamba2.stacked_states`` left a state that a
batch-of-one decode made as a partial sum over ``data`` to be all-reduced
once stacked.  Now:

- ``layers.embed`` is one ``on_local_shards`` body (``_sharded_embed``):
  each rank looks up the ids of its vocab rows, a ``Partial`` sum reduced
  once; a mesh dim splitting the table's M gathers the table (training,
  prefill) or the ids (a decode step), as ``layers._fsdp_layout`` chooses
  by bytes; the table's grad is reduced once, where
  ``models.loss_and_grads`` places it, a tied head's summed in first;
- ``layers.out_proj``: a decode step's projection on local shards, one
  all-reduce of (B, [1,] M) over ``model``;
- ``mamba2.stacked_states`` stacks on local shards, the SSD decode step
  (``mamba2._ssd_step_local``) makes its state in the cache's layout.

On meta DTensors of a fake (data=2, model=2) world, and a (pod=2, data=2,
model=2) one, for the smoke llama3.2-1b, mixtral-8x22b, mamba2-780m,
hymba-1.5b and minicpm-2b (tied table): a decode step's embedding moves no
table rows and reduces one (B, 1, M) (mamba2: (B, M)); each layer's
output projection issues one all-reduce of (B, 1, M) and no other
reduction; stacking the SSM states issues no all-reduce (a batch of one
too, as the ``long_500k`` cells decode); a train step reduces the
table's grad once at most, and never the whole table (each rank its
vocab rows), with either layout of ``data``.  On 4 gloo ranks: ``embed``
and ``out_proj`` against the unsharded ones on numpy inputs from a seed,
each layout forced, the output and the table's grad (tied and untied)
within 1e-5 of the largest magnitude; and the smoke mamba2-780m, hymba-1.5b
and llama3.2-1b serving a batch of one, as the long_500k cells do: its
rows whole on every data rank, each product by a weight whose M ``data``
splits is a partial sum over ``data``, which the SSM branch used to read
unreduced (its conv, gate and step are not linear: the logits were off
by up to half their largest magnitude), against the unsharded port in
fp32.

This file imports no JAX: it runs on a host that has torch alone.
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
from repro_torch.models import hybrid, layers, mamba2, transformer
from repro_torch.parallel.sharding import place, use_sharding

WORLD, B = 4, 4
ARCHS = ("llama3.2-1b", "mixtral-8x22b", "mamba2-780m", "hymba-1.5b",
         "minicpm-2b")
SSM_ARCHS = ("mamba2-780m", "hymba-1.5b")
MESHES = ("2x2", "2x2x2")
# the steps on the fake worlds: kind -> (sequence length, batch); the
# prefill past the smoke mixtral's and hymba's 32-token windows, "decode1"
# a batch of one, as the long_500k cells decode
STEPS = {"train": (64, B), "prefill": (40, B), "decode": (64, B),
         "decode1": (64, 1)}
MODULES = (transformer, mamba2, hybrid)
REDUCTIONS = ("all-reduce", "reduce-scatter")
LAYOUTS = ("gather_w", "gather_h")
RANKS_TIMEOUT_S = 300


# ------------------------------------------------ meta worlds: collectives
@pytest.fixture(params=MESHES)
def mesh(request):
    """A fake (data=2, model=2) or (pod=2, data=2, model=2) mesh,
    destroyed after the test."""
    shape = (2, 2) if request.param == "2x2" else (2, 2, 2)
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                         "model")
    with fake_world(int(np.prod(shape))):
        yield DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(
            shape), mesh_dim_names=names)
    assert not dist.is_initialized()


@dataclasses.dataclass
class _Seen:
    kind: str
    redistribution: int | None   # its number; None where none issued it
    shape: tuple | None     # the global shape of the DTensor moved
    src: str | None         # its placements before and after
    dst: str | None
    dtype: torch.dtype | None
    region: str | None      # the port function open at the time


class _Sites(dryrun.StepCounter):
    """The dry run's counter, which also keeps each collective's kind, the
    redistribution that issued it (its number, the global shape, placements
    before and after and dtype of the DTensor it moves; None where no
    redistribution issued it) and the region open at the time
    (``embed``, ``out_proj``, ``stacked_states`` or None): ``seen``, a
    ``_Seen`` each; ``calls`` counts each region's calls."""

    def __init__(self, args=()):
        super().__init__(args)
        self.seen, self.specs, self.region = [], [], None
        self.n_redistributions = 0
        self.calls = {"embed": 0, "out_proj": 0, "stacked_states": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        kind = self._kinds.get(getattr(func, "_overloadpacket", None))
        if kind is not None and out is not NotImplemented:
            spec = self.specs[-1] if self.specs else (None,) * 5
            self.seen.append(_Seen(kind, *spec, self.region))
        return out


def _pls(pls) -> str:
    return ",".join("P" if p.is_partial() else "R" if p.is_replicate()
                    else f"S{p.dim}" for p in pls)


@contextlib.contextmanager
def _watching(sites: _Sites):
    """While open, DTensor's redistributions push (the global shape of the
    DTensor they move, its placements before and after, its dtype, and
    their number) onto
    ``sites.specs``, and ``sites.region`` names the function of the models'
    ``embed``, ``out_proj`` (absent before fault L's repair: nothing to
    mark) and ``stacked_states`` that runs."""
    import torch.distributed.tensor._dispatch as dispatch
    import torch.distributed.tensor._redistribute as redistribute

    orig = redistribute.redistribute_local_tensor

    def named(local, current_spec, target_spec, *args, **kwargs):
        sites.n_redistributions += 1
        sites.specs.append((sites.n_redistributions,
                            tuple(current_spec.shape),
                            _pls(current_spec.placements),
                            _pls(target_spec.placements),
                            current_spec.tensor_meta.dtype))
        try:
            return orig(local, current_spec, target_spec, *args, **kwargs)
        finally:
            sites.specs.pop()

    def marked(name, fn):
        def run(*args, **kwargs):
            outer, sites.region = sites.region, name
            sites.calls[name] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                sites.region = outer
        return run

    with pytest.MonkeyPatch.context() as mp_:
        for mod in (dispatch, redistribute):
            mp_.setattr(mod, "redistribute_local_tensor", named)
        for mod in MODULES:
            for name in sites.calls:
                if hasattr(mod, name):
                    mp_.setattr(mod, name, marked(name, getattr(mod, name)))
        yield


def _step(arch: str, kind: str, mesh, changes=None) -> tuple:
    """``kind``'s smoke step of ``arch`` on meta DTensors of ``mesh``, run
    once under ``_watching`` and the dry run's own all-to-all: (sites,
    the config)."""
    cfg = dataclasses.replace(tconfigs.get_smoke_config(arch),
                              **(changes or {}))
    seq, batch = STEPS[kind]
    shape = tconfigs.ShapeSpec(f"{arch}-{kind}",
                               "decode" if kind == "decode1" else kind,
                               seq, batch)
    with use_sharding(mesh):
        step, args, _ = dryrun.build_step_and_specs(cfg, shape)
        sites = _Sites(args)
        with _watching(sites), dryrun.native_all_to_all(), sites:
            step(*args)
    return sites, cfg, shape.global_batch


def _rows(arch: str, batch: int, cfg) -> tuple:
    """The global shape of a decode step's (B, 1, M) rows; mamba2's
    recurrent step takes (B, M)."""
    return (batch, cfg.d_model) if arch == "mamba2-780m" else \
        (batch, 1, cfg.d_model)


def _table(cfg) -> set:
    """The shapes of the table's grad: (V, M), and where the head is the
    table's transpose, (M, V) too."""
    table = (cfg.padded_vocab, cfg.d_model)
    return {table, table[::-1]} if cfg.tie_embeddings else {table}


@pytest.mark.parametrize("kind", ["decode", "decode1"])
@pytest.mark.parametrize("arch", ARCHS)
def test_a_decode_embedding_gathers_no_table_rows_and_reduces_one_row(
        mesh, arch, kind):
    """A decode step's embedding moves no DTensor of the table's shape and
    reduces exactly one DTensor, the (B, 1, M) rows (mamba2's (B, M)),
    from a partial sum over ``model`` in one all-reduce; the ids (4 B a
    token) and the rows' M slices are all it moves besides."""
    sites, cfg, batch = _step(arch, kind, mesh)
    assert sites.calls["embed"] == 1
    seen = [x for x in sites.seen if x.region == "embed"]
    assert not [x for x in seen if x.shape in _table(cfg)], seen
    reduced = [x for x in seen if x.kind in REDUCTIONS]
    assert [(x.kind, x.shape, x.src.split(",")[-1]) for x in reduced] == \
        [("all-reduce", _rows(arch, batch, cfg), "P")], seen


@pytest.mark.parametrize("kind", ["decode", "decode1"])
@pytest.mark.parametrize("arch", ARCHS)
def test_each_decode_output_projection_issues_one_all_reduce(mesh, arch,
                                                              kind):
    """Each layer's output projection in a decode step (``out_proj``: the
    attention's ``wo``, mamba2's ``out_proj``, hymba's fused ``wo``)
    reduces one DTensor, the (B, 1, M) partial sum over ``model``, in one
    all-reduce, and nothing else."""
    sites, cfg, batch = _step(arch, kind, mesh)
    assert sites.calls["out_proj"] == cfg.n_layers
    reduced = [(x.kind, x.shape, x.src.split(",")[-1])
               for x in sites.seen if x.region == "out_proj"
               and x.kind in REDUCTIONS]
    assert reduced == [("all-reduce", _rows(arch, batch, cfg), "P")] * \
        cfg.n_layers, reduced


@pytest.mark.parametrize("kind", ["prefill", "decode", "decode1"])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_stacking_the_ssm_states_issues_no_all_reduce(mesh, arch, kind):
    """Stacking the caches' conv and SSD states issues no all-reduce (a
    state is no partial sum), and after a decode step no collective at
    all: the step makes each state where the cache keeps it."""
    sites, cfg, batch = _step(arch, kind, mesh)
    assert sites.calls["stacked_states"] == 1
    seen = [x for x in sites.seen if x.region == "stacked_states"]
    assert not [x for x in seen if x.kind == "all-reduce"], seen
    if kind != "prefill":
        assert not seen, seen
        # nor is a layer's state all-reduced in the step that makes it
        heads = cfg.ssm_heads if arch == "mamba2-780m" else \
            cfg.d_inner_hybrid // cfg.ssm_head_dim
        state = batch * heads * cfg.ssm_state * cfg.ssm_head_dim
        assert not [x for x in sites.seen if x.kind == "all-reduce"
                    and x.shape is not None and x.dtype == torch.float32
                    and np.prod(x.shape) >= state], sites.seen


# a tied table trains with the table gathered: the lookup's grad, like the
# head's, is then a partial sum over data, summed with it and reduced once
# (under "gather_h" the lookup's grad is each rank's own over data, which
# the head's partial sum meets in a reduce-scatter of its own)
@pytest.mark.parametrize("arch,layout", [
    (arch, layout) for arch in ARCHS for layout in LAYOUTS
    if layout == "gather_w" or arch != "minicpm-2b"])
def test_a_train_step_reduces_the_table_grad_once(mesh, arch, layout):
    """A train step (remat off) with ``data``'s layout of the lookup
    forced: the table's grad (with minicpm's tied head's, summed first)
    is reduced once at most, each rank its own vocab rows (the reduction's
    source keeps the vocab split over ``model``), never the whole table;
    gathering the table (``"gather_w"``), or a tied head, reduces it
    exactly once, a reduce-scatter over ``data`` into its placements
    among the collectives of that one redistribution."""
    orig = layers._fsdp_layout

    def forced(*args):
        return layout if forced.embed else orig(*args)

    def embed(*args, **kwargs):
        forced.embed = True
        try:
            return orig_embed(*args, **kwargs)
        finally:
            forced.embed = False

    forced.embed = False
    orig_embed = layers.embed
    with pytest.MonkeyPatch.context() as mp_:
        mp_.setattr(layers, "_fsdp_layout", forced)
        for mod in MODULES:
            mp_.setattr(mod, "embed", embed)
        sites, cfg, _ = _step(arch, "train", mesh, {"remat": False})
    grads = {}
    for x in sites.seen:
        if x.kind in REDUCTIONS and x.shape in _table(cfg) \
                and x.dtype == torch.float32:
            grads.setdefault(x.redistribution, []).append(x)
    assert len(grads) <= 1, grads
    for got in grads.values():
        # the vocab stays split over model (the last mesh dim) while reduced
        vocab = 0 if got[0].shape == (cfg.padded_vocab, cfg.d_model) else 1
        assert got[0].src.split(",")[-1] == f"S{vocab}", got
    if layout == "gather_w" or cfg.tie_embeddings:
        (got,), = grads.values(),
        assert "reduce-scatter" in {x.kind for x in got}, got


@pytest.mark.parametrize("cell,want", [
    # a device's local shards on 16x16 (data 16): mixtral-8x22b's table
    # (32768 / 16, 6144 / 16) fp32, its train_4k ids (16, 4096) int32 and
    # bf16 rows (16, 4096, 6144)
    (dict(h=16 * 4096 * 4, w=2048 * 384 * 4, y=16 * 4096 * 6144 * 2,
          rows_split=True, f_free=False), "gather_w"),
    # its prefill_32k: ids (2, 32768)
    (dict(h=2 * 32768 * 4, w=2048 * 384 * 4, y=2 * 32768 * 6144 * 2,
          rows_split=True, f_free=False), "gather_w"),
    # its decode_32k: ids (8, 1)
    (dict(h=8 * 4, w=2048 * 384 * 4, y=8 * 6144 * 2, rows_split=True,
          f_free=False), "gather_h"),
    # long_500k: one id, whole on every data rank
    (dict(h=4, w=2048 * 384 * 4, y=6144 * 2, rows_split=False,
          f_free=False), "gather_h")],
    ids=["train", "prefill", "decode", "batch-of-one"])
def test_the_lookup_layout_moves_the_fewest_bytes(cell, want):
    """``_fsdp_layout``, as the lookup asks it: the table gathered over
    ``data`` where the tokens are many (training, prefill), the ids where
    they are few (a decode step): the table's (V / 16, M) shard is never
    gathered each step."""
    assert layers._fsdp_layout(16, **cell) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_the_steps_keep_their_flops(arch):
    """The world's matmul FLOPs of the smoke train, prefill and decode
    steps on the 2x2 world equal the unsharded steps'."""
    with fake_world(WORLD):
        mesh = DeviceMesh("cpu", torch.arange(WORLD).reshape(2, 2),
                          mesh_dim_names=("data", "model"))
        cfg = tconfigs.get_smoke_config(arch)
        for kind in ("train", "prefill", "decode"):
            seq, batch = STEPS[kind]
            shape = tconfigs.ShapeSpec(kind, kind, seq, batch)
            got = dryrun.run_cell(cfg, shape, mesh)
            want = dryrun.run_cell(cfg, shape, None)
            assert got["matmul_flops"] == want["matmul_flops"], kind


# ------------------------------------------------ 4 gloo ranks: values
# the lookups and projections on the ranks: case -> (vocab, M, K, the ids'
# shape); 1-D ids as mamba2's decode step takes them, a batch of one as
# the long_500k cells decode
CASES = {"prefill": (64, 16, 24, (B, 6)), "decode": (64, 16, 24, (B, 1)),
         "ids-1d": (64, 16, 24, (B,)), "batch-of-one": (64, 16, 24, (1, 1))}
RUNS = [f"{case}:{layout}:{tied}" for case in CASES for layout in LAYOUTS
        for tied in ("untied", "tied")]


def _inputs(case: str) -> dict:
    """The table, the ids (every vocab shard's rows among them), the
    rows the projection takes and the cotangents, from a seed."""
    V, M, K, ids = CASES[case]
    rng = np.random.default_rng(11)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"table": normal(V, M), "ids": rng.integers(0, V, ids).astype(
                np.int32),
            "gy": normal(*ids, M), "h": normal(*ids, M),
            "gz": normal(*ids, V), "o": normal(*ids, K), "w": normal(K, M)}


def _names(ndim: int, last: str) -> tuple:
    return ("batch", *(None,) * (ndim - 2), last)


def _run(case: str, layout: str, tied: str, mesh=None) -> dict:
    """``embed`` (and, ``tied``, a head by the table's transpose) and
    ``out_proj`` of ``case`` under ``mesh`` (None: unsharded) with
    ``data``'s layout forced: the lookup, the table's grad of the loss
    sum(y * gy) (+ sum((h @ tableᵀ) * gz)), and the projection, each
    whole; under a mesh the output placements."""
    a = _inputs(case)
    nd = a["ids"].ndim + 1
    with use_sharding(mesh), pytest.MonkeyPatch.context() as mp_:
        mp_.setattr(layers, "_fsdp_layout", lambda *args: layout)
        table = place(torch.from_numpy(a["table"]), ("vocab", "embed")
                      ).detach().requires_grad_()
        ids = place(torch.from_numpy(a["ids"]), ("batch",) + (None,) * (
            nd - 2))
        y = layers.embed(table, ids, torch.float32)
        loss = (y * place(torch.from_numpy(a["gy"]), _names(
            nd, "act_embed"))).sum()
        if tied == "tied":
            h = place(torch.from_numpy(a["h"]), _names(nd, "act_embed"))
            z = h @ table.T
            loss = loss + (z * place(torch.from_numpy(a["gz"]), _names(
                nd, "vocab"))).sum()
        loss.backward()
        o = place(torch.from_numpy(a["o"]), _names(nd, "act_heads"))
        w = place(torch.from_numpy(a["w"]), ("heads", "embed"))
        like = place(torch.zeros(a["gy"].shape), _names(nd, "act_embed"))
        with torch.no_grad():
            p = layers.out_proj(o, w, like)
    out = {"y": _np(y), "grad.table": _np(table.grad), "proj": _np(p)}
    if mesh is not None:
        out["pls:y"] = np.asarray(str(tuple(y.placements)))
        out["pls:proj"] = np.asarray(str(tuple(p.placements)))
        out["pls:like"] = np.asarray(str(tuple(like.placements)))
    return out


# serving a batch of one (the long_500k cells' batch) on the mesh: the
# rows whole on every data rank, the weights' M split over data, so that
# each product by them is a partial sum over data (an SSM branch's in_proj
# too, whose blocks the conv, the gate and the step read)
ONE_ARCHS = ("mamba2-780m", "hymba-1.5b", "llama3.2-1b")
ONE_PROMPT, ONE_DECODES = 24, 2


@contextlib.contextmanager
def _fp32_activations():
    """The port's models in fp32 activations while open."""
    with pytest.MonkeyPatch.context() as mp_:
        for mod in MODULES:
            mp_.setattr(mod, "ACT_DTYPE", torch.float32)
        yield


def _serve_one(arch: str, mesh=None) -> dict:
    """``arch``'s smoke prefill of one prompt and ONE_DECODES decode
    steps under ``mesh`` (None: unsharded), in fp32 activations, on
    weights and tokens from a seed: the logits of each, whole."""
    from repro_torch.models import (get_model, make_decode_step,
                                    make_prefill_step)

    cfg = tconfigs.get_smoke_config(arch)
    model = get_model(cfg)
    rng = np.random.default_rng(5)
    defs = model.param_defs()
    tokens = rng.integers(0, cfg.vocab_size, (1, ONE_PROMPT + ONE_DECODES))
    out = {}
    with _fp32_activations(), use_sharding(mesh), torch.no_grad():
        params = {k: place(torch.from_numpy((0.2 * rng.standard_normal(
            d.shape)).astype(np.float32)), d.names) for k, d in defs.items()}
        ids = tokens.astype(np.int32)
        logits, cache = make_prefill_step(model)(params, {
            "tokens": place(torch.from_numpy(ids[:, :ONE_PROMPT]),
                            ("batch", "seq"))})
        out["prefill"] = _np(logits)
        for i in range(ONE_DECODES):
            step = ids[:, ONE_PROMPT + i:ONE_PROMPT + i + 1].copy()
            logits, cache = make_decode_step(model)(
                params, place(torch.from_numpy(step), ("batch", None)),
                cache)
            out[f"decode{i}"] = _np(logits)
    return out


def _np(t: torch.Tensor) -> np.ndarray:
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    return t.detach().numpy()


def _rank_main(rank: int, tmp: str) -> None:
    """One of the 4 gloo ranks: each run's ``_run`` on the (data, model)
    mesh, written to ``rank{rank}_{run}.npz``."""
    torch.set_num_threads(1)
    tmp = Path(tmp)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp / "store"), WORLD), rank=rank, world_size=WORLD)
    try:
        mesh = DeviceMesh("cpu", torch.arange(WORLD).reshape(2, 2),
                          mesh_dim_names=("data", "model"))
        for run in RUNS:
            np.savez(tmp / f"rank{rank}_{run}.npz",
                     **_run(*run.split(":"), mesh))
        for arch in ONE_ARCHS:
            np.savez(tmp / f"rank{rank}_one_{arch}.npz",
                     **_serve_one(arch, mesh))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory) -> dict:
    """run (and one_<arch>) -> {"sharded": rank 0's outputs, "port": the
    unsharded ones}."""
    tmp = tmp_path_factory.mktemp("embed4")
    ranks = mp.start_processes(_rank_main, args=(str(tmp),), nprocs=WORLD,
                               join=False, start_method="spawn")
    out = {run: {"port": _run(*run.split(":"))} for run in RUNS}
    out.update({f"one_{arch}": {"port": _serve_one(arch)}
                for arch in ONE_ARCHS})
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    while not ranks.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ranks.processes:
                p.kill()
            raise TimeoutError(f"the {WORLD} ranks ran past "
                               f"{RANKS_TIMEOUT_S} s")
    for run in (*RUNS, *(f"one_{arch}" for arch in ONE_ARCHS)):
        got = [dict(np.load(tmp / f"rank{r}_{run}.npz"))
               for r in range(WORLD)]
        for other in got[1:]:   # every rank gathers the same full tensors
            assert all(np.array_equal(other[k], got[0][k]) for k in got[0]
                       if not k.startswith("pls:"))
        out[run]["sharded"] = got[0]
    return out


@pytest.mark.parametrize("run", RUNS)
def test_the_lookup_and_the_projection_match_unsharded(runs, run):
    """The lookup, the table's grad (a tied head's beside the lookup's)
    and the decode projection on the 2x2 mesh, ``data``'s layout forced,
    against the unsharded ones in fp32, each within 1e-5 of the unsharded
    tensor's largest magnitude; the lookup and the projection come back
    laid out as the residual: the batch over ``data`` where it divides,
    whole over ``model``."""
    got, want = runs[run]["sharded"], runs[run]["port"]
    for k in ("y", "grad.table", "proj"):
        assert np.abs(want[k]).max() > 0, k
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-5 * np.abs(want[k]).max(),
                                   err_msg=k)
    assert str(got["pls:y"]) == str(got["pls:like"])
    assert str(got["pls:proj"]) == str(got["pls:like"])
    rows = "Replicate()" if run.startswith("batch-of-one") else \
        "Shard(dim=0)"
    assert str(got["pls:like"]) == f"({rows}, Replicate())"


@pytest.mark.parametrize("arch", ONE_ARCHS)
def test_a_batch_of_one_serves_as_unsharded(runs, arch):
    """A batch of one, prompt and decode steps, on the 2x2 mesh against
    the unsharded port in fp32, the logits of each step within 1e-5 of
    their largest magnitude: the SSM branch reads no partial sum (the
    products by in_proj reduced first, ``mamba2.proj_blocks``), the
    lookup's and the projections' rows whole on every data rank."""
    got, want = runs[f"one_{arch}"]["sharded"], runs[f"one_{arch}"]["port"]
    assert sorted(got) == sorted(want) == \
        ["decode0", "decode1", "prefill"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-5 * np.abs(want[k]).max(),
                                   err_msg=k)


def test_the_ids_reach_every_vocab_shard():
    """Each case's ids fall in both halves of the vocab, so that both
    model ranks' lookups add rows; a batch of one holds one id."""
    for case in CASES:
        ids = _inputs(case)["ids"]
        half = CASES[case][0] // 2
        if ids.size > 1:
            assert (ids < half).any() and (ids >= half).any(), case


def test_without_a_mesh_the_lookup_is_the_indexing():
    """Without a mesh ``embed`` is ``table[tokens]``, cast where asked,
    bit for bit, and its grad the indexing's."""
    a = _inputs("prefill")
    t1 = torch.from_numpy(a["table"]).requires_grad_()
    t2 = torch.from_numpy(a["table"]).requires_grad_()
    ids = torch.from_numpy(a["ids"]).long()
    y1 = layers.embed(t1, ids, torch.bfloat16)
    y2 = t2[ids].to(torch.bfloat16)
    assert torch.equal(y1, y2)
    gy = torch.from_numpy(a["gy"]).to(torch.bfloat16)
    (y1.float() * gy).sum().backward()
    (y2.float() * gy).sum().backward()
    assert torch.equal(t1.grad, t2.grad)
    assert torch.equal(layers.embed(t1, ids), t1[ids])
