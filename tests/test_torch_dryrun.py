"""The port's dry run (``repro_torch.launch.dryrun``) and the port's steps on
its own stand-ins (ROADMAP.md, Queue 3, fault C), on the CPU.

Every world here is torch's fake process group, started and destroyed by
``mesh.fake_world`` inside a fixture or test, so that no group outlives its
test.  FLOPs and bytes are integers and held exactly: the step counter's
collective bytes and per-device FLOPs on hand-built DTensor ops, the world
matmul FLOPs of the smoke llama3.2-1b against the closed form of its
config, with no mesh and on a 2x2 (data, model) world, a train step's
under each remat policy, and the argument bytes of a smoke train cell
against JAX's ``memory_analysis``; the temp bytes against the closed form
of a chain of products, and a train cell's falling under remat.  The skip
list is the reference's, cell for cell.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import repro.configs as jconfigs
import repro.models as jmodels
from repro.optimizer import AdamWState
from repro.parallel.sharding import use_sharding as jax_use_sharding
from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.models import (get_model, make_decode_step, make_encode_step,
                                make_prefill_step, make_train_step)
from repro_torch.optimizer import abstract_opt_state
from repro_torch.parallel.sharding import abstract_tensor, use_sharding

SMALL = {"train": tconfigs.ShapeSpec("t", "train", 64, 4),
         "prefill": tconfigs.ShapeSpec("p", "prefill", 64, 4),
         "decode": tconfigs.ShapeSpec("d", "decode", 64, 4)}


@pytest.fixture
def mesh2x2():
    """A (data=2, model=2) mesh over a fake world of 4 ranks, destroyed
    after the test."""
    with fake_world(4):
        yield DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                         mesh_dim_names=("data", "model"))
    assert not dist.is_initialized()


def _dt(mesh, shape, pls):
    return abstract_tensor(shape, torch.float32, (mesh, pls))


# ------------------------------------------- twin of the reference's helpers
def test_collective_bytes_of_hand_built_ops(mesh2x2):
    """Twin of tests/test_system.py::test_dryrun_cell_machinery_importable:
    each collective counts its result's bytes on the local shard once."""
    m = mesh2x2
    counter = dryrun.StepCounter()
    with use_sharding(m), dryrun.native_all_to_all(), counter:
        # (8, 32) fp32 sharded on both axes -> replicated: gathers of the
        # (8, 16) half on data, then of the whole (8, 32) on model
        _dt(m, (8, 32), [Shard(0), Shard(1)]).redistribute(
            m, [Replicate(), Replicate()])
        _dt(m, (8, 32), [Partial(), Replicate()]).redistribute(
            m, [Replicate(), Replicate()])
        _dt(m, (8, 32), [Partial(), Replicate()]).redistribute(
            m, [Shard(0), Replicate()])
        out = _dt(m, (8, 32), [Shard(0), Replicate()]).redistribute(
            m, [Shard(1), Replicate()])
    assert out.to_local().shape == (8, 16)
    assert counter.collectives == {
        "all-gather": 8 * 16 * 4 + 8 * 32 * 4, "all-reduce": 8 * 32 * 4,
        "reduce-scatter": 4 * 32 * 4, "all-to-all": 8 * 16 * 4,
        "collective-permute": 0, "count": 5}
    assert dryrun.COLLECTIVES == ("all-gather", "all-reduce",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute")


def test_matmul_flops_of_a_sharded_matmul_world_and_per_device(mesh2x2):
    m = mesh2x2
    x = _dt(m, (8, 16), [Shard(0), Replicate()])
    w = _dt(m, (16, 32), [Replicate(), Shard(1)])
    counter = dryrun.StepCounter()
    with use_sharding(m), counter:
        y = x @ w
    assert y.placements == (Shard(0), Shard(1))
    assert counter.totals() == (2 * 8 * 16 * 32, 2 * 4 * 16 * 16)
    assert counter.collectives["count"] == 0


def test_without_a_mesh_world_and_device_flops_are_one_count():
    counter = dryrun.StepCounter()
    with counter:
        torch.empty(8, 16, device="meta") @ torch.empty(16, 32,
                                                         device="meta")
    assert counter.totals() == (2 * 8 * 16 * 32,) * 2


def test_fake_world_is_destroyed_on_error_and_refuses_a_running_one():
    with pytest.raises(ZeroDivisionError):
        with fake_world(4):
            assert dist.get_world_size() == 4
            with pytest.raises(RuntimeError, match="running already"):
                with fake_world(2):
                    pass
            1 / 0
    assert not dist.is_initialized()


# ------------------------------------------------- fault C: the step builders
def _cells():
    for arch in tconfigs.ARCH_IDS:
        cfg = tconfigs.get_smoke_config(arch)
        for kind, shape in SMALL.items():
            if tconfigs.cell_skip_reason(cfg, shape) is None:
                yield arch, kind


@pytest.mark.parametrize("arch,kind", list(_cells()),
                         ids=lambda v: str(v))
def test_steps_run_on_meta_dtensors(mesh2x2, arch, kind):
    """Fault C: the train, prefill (encode) and decode steps of every
    arch's smoke config run on ``abstract_params`` and ``input_specs`` as
    meta DTensors of a 2x2 world, and return global shapes."""
    cfg = tconfigs.get_smoke_config(arch)
    shape = SMALL[kind]
    B, V = shape.global_batch, cfg.padded_vocab
    with use_sharding(mesh2x2):
        model = get_model(cfg)
        params = model.abstract_params()
        specs = tconfigs.input_specs(cfg, shape)
        assert all(isinstance(p, DTensor) for p in params.values())
        if kind == "train":
            new, opt, metrics = make_train_step(model)(
                params, abstract_opt_state(params), specs["batch"])
            assert {k: v.shape for k, v in new.items()} == \
                {k: v.shape for k, v in params.items()}
            assert all(isinstance(v, DTensor) and v.device.type == "meta"
                       for v in (*new.values(), *opt.mu.values()))
            assert metrics["loss"].shape == ()
        elif cfg.family == "encoder":
            logits = make_encode_step(model)(params, specs["batch"])
            assert logits.shape == (B, shape.seq_len, V)
        elif kind == "prefill":
            logits, cache = make_prefill_step(model)(params, specs["batch"])
            assert logits.shape == (B, 1, V)
            assert int(cache["pos"]) == shape.seq_len
        else:
            logits, cache = make_decode_step(model)(
                params, specs["tokens"], specs["cache"])
            assert logits.shape == (B, 1, V)
            assert int(cache["pos"]) == tconfigs.decode_pos(shape) + 1
    assert isinstance(logits if kind != "train" else metrics["loss"],
                      DTensor)


def test_abstract_opt_state_takes_the_parameters_placements(mesh2x2):
    with use_sharding(mesh2x2):
        params = get_model(tconfigs.get_smoke_config("llama3.2-1b")
                           ).abstract_params()
        opt = abstract_opt_state(params)
    for k, p in params.items():
        for moment in (opt.mu[k], opt.nu[k]):
            assert moment.dtype == torch.float32 and moment.shape == p.shape
            assert moment.placements == p.placements
            assert moment.to_local().device.type == "meta"
    assert opt.step.shape == () and opt.step.dtype == torch.int32
    assert opt.step.placements == (Replicate(), Replicate())


def test_a_dtensor_on_the_card_raises_and_never_runs_plain(mesh2x2,
                                                          monkeypatch):
    """On DTensors on the card the norm and the attention launch the
    kernels on each rank's local shards (the launchers recorded here), and
    no plain version runs; a DTensor passed to an op directly still raises,
    as ``ops`` does for any kernel.  The CUDA tensors are fake
    (``FakeTensorMode``), so this runs on a host with no card."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as krms
    from repro_torch.models import layers

    ran, launched = [], []
    monkeypatch.setattr(krms, "plain", lambda *a, **k: ran.append("rms"))
    monkeypatch.setattr(kflash, "plain", lambda *a, **k: ran.append("fa"))

    def rms_launch(x, w, eps):
        launched.append(("rmsnorm", type(x) is not DTensor, tuple(x.shape),
                         tuple(w.shape)))
        return torch.empty_like(x)

    def flash_launch(q, k, v, **kw):
        launched.append(("flash", type(q) is not DTensor, tuple(q.shape),
                         tuple(k.shape)))
        return torch.empty_like(q)

    monkeypatch.setattr(krms, "rmsnorm", rms_launch)
    monkeypatch.setattr(kflash, "launch", flash_launch)
    card = DeviceMesh("cuda", torch.arange(4).reshape(2, 2),
                      mesh_dim_names=("data", "model"))
    with FakeTensorMode():
        x = torch.empty(2, 8, 64, device="cuda", dtype=torch.bfloat16)
        w = torch.empty(64, device="cuda")
        q = torch.empty(4, 4, 8, 16, device="cuda", dtype=torch.bfloat16)
        kv = torch.empty(4, 2, 8, 16, device="cuda", dtype=torch.bfloat16)
    rep = [Replicate(), Replicate()]
    dw, dq, dkv = (DTensor.from_local(t, card, rep, run_check=False)
                   for t in (w, q, kv))
    # the rows keep their layout: (4, 8, 64), the batch over data
    dx = DTensor.from_local(x, card, [Shard(0), Replicate()],
                            run_check=False)
    with use_sharding(card):
        out = layers.rmsnorm(dx, dw, 1e-5)
        assert out.shape == (4, 8, 64) and out.placements == dx.placements
        att = layers.attention(dq, dkv, dkv)
        assert att.shape == q.shape
        assert att.placements == (Shard(0), Shard(1))
        for fn, args in ((ops.rmsnorm, (dx.reshape(-1, 64), dw)),
                         (ops.flash_attention, (dq, dkv, dkv))):
            with pytest.raises(NotImplementedError,
                               match="DTensor on the card"):
                fn(*args)
    # the batch over data, the heads over model: each launch on one shard
    assert launched == [("rmsnorm", True, (16, 64), (64,)),
                        ("flash", True, (2, 2, 8, 16), (2, 1, 8, 16))]
    assert ran == []


# --------------------------------------------------------- the counted cells
def _skip_pairs(S: int, chunk: int) -> int:
    """(row, key) pairs of a causal block-skipping attention over S rows
    per (batch, head): each q chunk of ``chunk`` rows reads the keys up to
    its last row (the reference's ``_chunked_attention_skip``), so the
    sum over chunks i of chunk * (hi_i - lo_i)."""
    return sum(chunk * min(a + chunk, S) for a in range(0, S, chunk))


def _llama_smoke_flops(kind: str, B: int, S: int, data: int = 1,
                       model: int = 1, remat="nothing",
                       pairs: int | None = None) -> int:
    """Matmul FLOPs of the smoke llama3.2-1b from its config: the layer
    weights on every token, attention over every key (4 B H S^2 hd a layer:
    scores and values; ``pairs`` in place of S^2 where the attention skips
    blocks, ``_skip_pairs``), and the LM head (the last token alone in a
    prefill).  A train step's backward takes two matmuls a forward one:
    3x the forward, and recomputes as ``remat`` (the policy, or False)
    says: under ``"nothing"`` the layers' forward again but each layer's
    last product (the FFN's down projection, 2 B S F M a layer, whose
    output no backward reads), under ``"dots"`` the attention's products
    with batch dims (4 B H S^2 hd a layer).  On a (data, model) mesh, one
    device's: the batch split over ``data``, and the q and kv heads, the
    FFN's hidden dim and the vocab over ``model`` (the smoke's 4 q and 2 kv
    heads divide 2)."""
    cfg = tconfigs.get_smoke_config("llama3.2-1b")
    L, M, H, KV, hd, F = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                          cfg.n_kv_heads, cfg.hd, cfg.d_ff)
    V = cfg.padded_vocab
    assert H % model == KV % model == F % model == V % model == 0
    B, H, KV, F, V = (B // data, H // model, KV // model, F // model,
                      V // model)
    layer_weights = L * (2 * M * H * hd + 2 * M * KV * hd + 3 * M * F)
    if kind == "decode":   # one token over a cache of S slots
        return 2 * layer_weights * B + 4 * B * H * S * hd * L + 2 * B * M * V
    pairs = S * S if pairs is None else pairs
    fwd = 2 * layer_weights * B * S + 4 * B * H * pairs * hd * L
    if kind == "prefill":
        return fwd + 2 * B * M * V
    recompute = {"nothing": fwd - 2 * B * S * F * M * L,
                 "dots": 4 * B * H * pairs * hd * L, False: 0}[remat]
    return 3 * (fwd + 2 * B * S * M * V) + recompute


# block-skipping attention over SMALL's 64 tokens in 4 chunks of 16
SKIP = dict(swa_block_skip=True, attn_chunk=16, dense_attn_max_seq=16)


@pytest.mark.parametrize("on_mesh", [False, True], ids=["no_mesh", "2x2"])
@pytest.mark.parametrize("kind,remat,attn", [
    ("prefill", "nothing", {}), ("train", "nothing", {}),
    ("decode", "nothing", {}), ("train", "dots", {}), ("train", False, {}),
    ("prefill", "nothing", SKIP), ("train", "nothing", SKIP),
    ("train", "dots", SKIP)],
    ids=["prefill", "train", "decode", "train-dots", "train-no_remat",
         "prefill-skip", "train-skip", "train-dots-skip"])
def test_matmul_flops_equal_the_closed_form(kind, remat, attn, on_mesh):
    """The world's FLOPs are the closed form's on either; on the 2x2 mesh a
    device runs its own share of every matmul and of attention, heads and
    batch sharded (the norms and attention on local shards, counted into
    the world's by the pieces the mesh splits them into, the recomputed
    bodies as the first ones).  A train step recomputes as its remat
    policy says (the default ``"nothing"``, ``"dots"``, or none).  Under
    ``swa_block_skip`` (``-skip``) attention reads ``_skip_pairs`` (row,
    key) pairs in place of S^2, the ``"dots"`` recompute included."""
    cfg = dataclasses.replace(tconfigs.get_smoke_config("llama3.2-1b"),
                              **attn)
    cfg = dataclasses.replace(cfg, remat=False) if remat is False else \
        dataclasses.replace(cfg, remat_policy=remat)
    shape = SMALL[kind]
    pairs = _skip_pairs(shape.seq_len, SKIP["attn_chunk"]) if attn else None
    want = _llama_smoke_flops(kind, shape.global_batch, shape.seq_len,
                              remat=remat, pairs=pairs)
    if on_mesh:
        with fake_world(4):
            mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                              mesh_dim_names=("data", "model"))
            got = dryrun.run_cell(cfg, shape, mesh)
        assert got["chips"] == 4 and got["collectives"]["count"] > 0
        assert got["matmul_flops_per_device"] == _llama_smoke_flops(
            kind, shape.global_batch, shape.seq_len, data=2, model=2,
            remat=remat, pairs=pairs)
    else:
        got = dryrun.run_cell(cfg, shape, None)
        assert got["matmul_flops_per_device"] == want
        assert got["collectives"]["count"] == 0
    assert got["matmul_flops"] == want


# a decode's cache at two lengths: a positional cache of seq_len slots, or
# (the window below seq_len) a rolling one of the window's
DECODE_CACHES = {
    "llama3.2-1b": ("llama3.2-1b", {}, 4),
    "chatglm3-6b": ("chatglm3-6b", {}, 4),
    "llama3.2-1b-slots": ("llama3.2-1b", {}, 1),
    "mixtral-shifted": ("mixtral-8x22b", {"n_kv_heads": 1}, 4),
    "mixtral-ring": ("mixtral-8x22b", {"n_kv_heads": 1,
                                       "swa_ring_buffer": True}, 4),
}


@pytest.mark.parametrize("case", sorted(DECODE_CACHES))
def test_a_decode_gathers_no_cache(case):
    """A decode step on the fake 2x2 world writes its slot in place,
    attends over each rank's shard of the cache and shifts a rolling cache
    by one slot a shard: its collectives do not grow with the cache's
    length.  At batch 1 (``-slots``) and with one kv head (mixtral's) the
    slots are sharded (``kv_seq``), so the softmax combines across them;
    elsewhere the batch takes ``data`` and the kv heads ``model``.
    Gathering the cache, as DTensor does for an indexed write or a roll of
    a sharded dim, would move a layer's cache a step."""
    arch, changes, batch = DECODE_CACHES[case]
    moved = []
    for length in (64, 128):
        cfg = dataclasses.replace(tconfigs.get_smoke_config(arch),
                                  **changes)
        seq = length
        if cfg.window is not None:   # a rolling cache of ``length`` slots
            cfg, seq = dataclasses.replace(cfg, window=length), 256
        with fake_world(4):
            mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                              mesh_dim_names=("data", "model"))
            got = dryrun.run_cell(cfg, tconfigs.ShapeSpec(
                "d", "decode", seq, batch), mesh)
        moved.append(got["collectives"])
    assert moved[0] == moved[1]
    assert moved[0]["all-gather"] > 0   # the weights' FSDP gathers


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mixtral-8x22b"])
def test_a_decode_no_fsdp_decode_takes_the_serve_time_rules(mesh2x2, arch):
    """``decode_no_fsdp``: the weights' contracting dims stay local and
    their other dims take every mesh axis (src/repro/launch/dryrun.py:
    215-225), and the FFN takes replicated tokens: the same work in
    another program."""
    cfg = tconfigs.get_smoke_config(arch)
    base = dryrun.run_cell(cfg, SMALL["decode"], mesh2x2)
    serve = dryrun.run_cell(dataclasses.replace(cfg, decode_no_fsdp=True),
                            SMALL["decode"], mesh2x2)
    assert (base["rules"], serve["rules"]) == ("logical", "decode_no_fsdp")
    assert serve["matmul_flops"] == base["matmul_flops"]
    assert serve["collectives"]["count"] < base["collectives"]["count"]
    rules = {**dryrun.LOGICAL_RULES, **dryrun.DECODE_NO_FSDP_RULES}
    with use_sharding(mesh2x2, rules):
        wq = get_model(cfg).abstract_params()["layers.attn.wq"]
    # (layers, embed, heads): the heads over both axes, the embed dim local
    assert [pl.dim for pl in wq.placements] == [2, 2]


def test_argument_bytes_equal_jax_memory_analysis():
    """The smoke llama3.2-1b's train_4k cell on one device: params, AdamW
    state (two fp32 moments and the int32 step) and the int32 batch, as
    XLA's ``argument_size_in_bytes`` counts them."""
    jcfg = jconfigs.get_smoke_config("llama3.2-1b")
    jmodel = jmodels.get_model(jcfg)
    with jax_use_sharding(None):
        aparams = jmodel.abstract_params()
        f32 = lambda p: jax.ShapeDtypeStruct(p.shape, jnp.float32)  # noqa
        aopt = AdamWState(step=jax.ShapeDtypeStruct((), jnp.int32),
                          mu=jax.tree.map(f32, aparams),
                          nu=jax.tree.map(f32, aparams))
        batch = jconfigs.input_specs(jcfg, jconfigs.SHAPES["train_4k"])
        want = jax.jit(jmodels.make_train_step(jmodel), donate_argnums=(0, 1)
                       ).lower(aparams, aopt, batch["batch"]).compile(
                       ).memory_analysis().argument_size_in_bytes
    got = dryrun.run_cell(tconfigs.get_smoke_config("llama3.2-1b"),
                          tconfigs.SHAPES["train_4k"], None)["memory"]
    assert got["argument_size_bytes"] == want
    assert got["argument_size_bytes"] == got["params_bytes"] + \
        got["opt_state_bytes"] + got["inputs_bytes"]
    assert got["opt_state_bytes"] == 2 * got["params_bytes"] + 4
    assert isinstance(got["temp_size_bytes"], int) and \
        got["temp_size_bytes"] > got["output_size_bytes"] > 0
    assert got["generated_code_size_bytes"] is None


def test_temp_bytes_of_a_chain_of_products():
    """Three (8, 16) @ (16, 16) products in a chain on meta: without a
    graph one product's input and output are live at a time (the chain's
    input an argument, so the first product's output alone at first); with
    one the first two outputs are saved for the backward and the third is
    the result; with the backward inside, its peak is the second product's
    backward: the first output (saved), the result, its grad, the grads of
    the second output and of the first, and the last two weight grads."""
    x = torch.empty(8, 16, device="meta")
    ws = [torch.empty(16, 16, device="meta") for _ in range(3)]
    act, wgrad = 8 * 16 * 4, 16 * 16 * 4

    def chain(x, *ws):
        for w in ws:
            x = x @ w
        return x

    assert dryrun.temp_bytes(chain, x, *ws) == 2 * act
    ws = [w.requires_grad_() for w in ws]
    assert dryrun.temp_bytes(chain, x, *ws) == 3 * act

    def grads(x, *ws):
        out = chain(x, *ws)
        return torch.autograd.grad(out, ws, torch.ones_like(out))

    assert dryrun.temp_bytes(grads, x, *ws) == 5 * act + 2 * wgrad


class _SweepEachOp(TorchDispatchMode):
    """A reference for ``StepCounter``'s temp: after every op, the bytes of
    the live storages that the ops made, the dead ones dropped at once."""

    def __init__(self, args):
        super().__init__()
        self.args = {StorageWeakRef(t.untyped_storage())
                     for t in tree_leaves(args)
                     if isinstance(t, torch.Tensor)}
        self.live, self.peak = {}, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for ref in [r for r in self.live if r.expired()]:
            del self.live[ref]
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                ref = StorageWeakRef(t.untyped_storage())
                if ref not in self.live and ref not in self.args:
                    self.live[ref] = t.untyped_storage().nbytes()
        self.peak = max(self.peak, sum(self.live.values()))
        return out


@pytest.mark.parametrize("changes", [{"remat": False}, {},
                                     {"remat_policy": "dots"}],
                         ids=["no_remat", "nothing", "dots"])
def test_temp_bytes_equal_a_sweep_after_every_op(changes):
    """``StepCounter`` sweeps the dead storages only where its sum would
    pass the peak; its peak is the one of a sweep after every op, on the
    smoke llama3.2-1b's train step."""
    cfg = dataclasses.replace(tconfigs.get_smoke_config("llama3.2-1b"),
                              **changes)
    with use_sharding(None):
        step, args, _ = dryrun.build_step_and_specs(cfg, SMALL["train"])
        want = _SweepEachOp(args)
        with want:
            step(*args)
        assert dryrun.temp_bytes(step, *args) == want.peak > 0


@pytest.mark.parametrize("kind", ["no_mesh", "2x2"])
def test_remat_lowers_a_train_cells_temp_bytes(kind):
    """The smoke llama3.2-1b's train cell, with and without remat: the
    recompute keeps a layer's activations out of the forward's saved
    tensors, with no mesh and on the fake 2x2 world."""
    cfg = tconfigs.get_smoke_config("llama3.2-1b")
    temps = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        if kind == "2x2":
            with fake_world(4):
                mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                                  mesh_dim_names=("data", "model"))
                got = dryrun.run_cell(c, SMALL["train"], mesh)
        else:
            got = dryrun.run_cell(c, SMALL["train"], None)
        temps[remat] = got["memory"]["temp_size_bytes"]
    assert 0 < temps[True] < temps[False]


def test_state_bytes_are_the_params_and_their_moments():
    cfg = tconfigs.get_config("llama3.2-1b")
    n = get_model(cfg).param_count()
    assert dryrun.state_bytes(cfg) == {"params": 4 * n,
                                       "opt_state": 8 * n + 4}


@pytest.mark.parametrize("arch,shape", [
    (a, s) for a in tconfigs.ARCH_IDS for s in tconfigs.SHAPE_NAMES],
    ids=lambda v: str(v))
def test_skips_are_the_references(arch, shape):
    want = jconfigs.cell_skip_reason(jconfigs.get_config(arch),
                                     jconfigs.SHAPES[shape])
    if want is None:
        assert tconfigs.cell_skip_reason(tconfigs.get_config(arch),
                                         tconfigs.SHAPES[shape]) is None
    else:
        assert dryrun.dryrun_cell(arch, shape, None) == {
            "arch": arch, "shape": shape, "status": "skip", "reason": want}


# ----------------------------------------------------------------- the CLI
@pytest.mark.parametrize("knob", dryrun.NO_EFFECT)
def test_a_knob_the_port_does_not_read_is_refused(knob, capsys, tmp_path):
    """``scan_layers``, XLA's layer scan, has no counterpart in eager code:
    ``--set`` refuses it and writes nothing."""
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "llama3.2-1b", "--shape", "prefill_32k",
                     "--set", f"{knob}=True", "--out", str(tmp_path)])
    assert e.value.code == 2
    assert knob in capsys.readouterr().err
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("knob,value,remat", [
    ("remat", "False", False), ("remat_policy", "dots", "dots")])
def test_remat_knobs_are_taken(knob, value, remat, monkeypatch, tmp_path):
    """``--set remat=False`` and ``--set remat_policy=dots`` reach the
    model: a smoke train cell's FLOPs are the closed form's under each."""
    smoke = tconfigs.get_smoke_config("llama3.2-1b")
    monkeypatch.setattr(dryrun, "get_config", lambda arch: smoke)
    monkeypatch.setitem(dryrun.SHAPES, "train_4k", SMALL["train"])
    assert dryrun.main(["--arch", "llama3.2-1b", "--shape", "train_4k",
                        "--single-pod", "--set", f"{knob}={value}",
                        "--out", str(tmp_path)])["ok"] == 1
    res = json.loads((tmp_path / "single_pod" /
                      "llama3.2-1b__train_4k.json").read_text())
    assert res["overrides"] == {knob: repr(remat)}
    shape = SMALL["train"]
    assert res["matmul_flops"] == _llama_smoke_flops(
        "train", shape.global_batch, shape.seq_len, remat=remat)


# knob -> (the smoke config's attention before the --set, the value set,
# the (row, key) pairs a (batch, head) of SMALL's train cell reads after it)
ATTENTION_KNOBS = {
    "swa_block_skip": (dict(attn_chunk=16, dense_attn_max_seq=16), True,
                       _skip_pairs(64, 16)),
    "attn_chunk": (SKIP, 32, _skip_pairs(64, 32)),
    "dense_attn_max_seq": (SKIP, 64, 64 * 64),
}


@pytest.mark.parametrize("knob", sorted(ATTENTION_KNOBS))
def test_attention_knobs_are_taken(knob, monkeypatch, tmp_path):
    """``--set`` of each of the reference's three attention knobs reaches
    the model and is recorded in ``overrides``: the smoke train cell's
    FLOPs are the closed form's for the attention the knob leaves (block
    skipping turned on, a wider chunk, or the dense path up to 64), not
    the ones before it."""
    before, value, pairs = ATTENTION_KNOBS[knob]
    smoke = dataclasses.replace(tconfigs.get_smoke_config("llama3.2-1b"),
                                **before)
    monkeypatch.setattr(dryrun, "get_config", lambda arch: smoke)
    monkeypatch.setitem(dryrun.SHAPES, "train_4k", SMALL["train"])
    assert dryrun.main(["--arch", "llama3.2-1b", "--shape", "train_4k",
                        "--single-pod", "--set", f"{knob}={value}",
                        "--out", str(tmp_path)])["ok"] == 1
    res = json.loads((tmp_path / "single_pod" /
                      "llama3.2-1b__train_4k.json").read_text())
    assert res["overrides"] == {knob: repr(value)}
    b, s = SMALL["train"].global_batch, SMALL["train"].seq_len
    was = _skip_pairs(s, 16) if before is SKIP else s * s
    assert pairs != was
    assert res["matmul_flops"] == _llama_smoke_flops("train", b, s,
                                                     pairs=pairs)


def test_a_long_prefill_holds_one_chunk_of_scores_at_a_time():
    """Fault D's repair in the dry run: llama3.2-1b's prefill_32k on the
    16x16 mesh, under the reference's defaults (attention in q chunks of
    1024 above 1024 tokens), holds at most a tenth of the temp bytes a
    device holds under the dense program (``dense_attn_max_seq=32768``,
    three (2, 2, 32768, 32768) fp32 score tensors at once), at equal
    matmul FLOPs: chunking by q rows alone leaves the products whole."""
    with fake_world(256):
        mesh = make_production_mesh(multi_pod=False, device_type="cpu")
        chunked = dryrun.dryrun_cell("llama3.2-1b", "prefill_32k", mesh)
        dense = dryrun.dryrun_cell("llama3.2-1b", "prefill_32k", mesh,
                                   overrides={"dense_attn_max_seq": 32768})
    assert chunked["status"] == dense["status"] == "ok"
    assert chunked["matmul_flops"] == dense["matmul_flops"]
    assert chunked["matmul_flops_per_device"] == \
        dense["matmul_flops_per_device"]
    temp = chunked["memory"]["temp_size_bytes"]
    dense_temp = dense["memory"]["temp_size_bytes"]
    assert dense_temp >= 3 * 2 * 2 * 32768 ** 2 * 4
    assert 10 * temp <= dense_temp


def test_main_writes_a_cell_resumes_and_recomputes_with_force(tmp_path,
                                                               capsys):
    """The full llama3.2-1b decode_32k cell on the 16x16 mesh: the one
    full-config cell of this file."""
    argv = ["--arch", "llama3.2-1b", "--shape", "decode_32k",
            "--single-pod", "--out", str(tmp_path), "--no-cost-accounting"]
    assert dryrun.main(argv) == {"ok": 1, "skip": 0, "fail": 0}
    assert not dist.is_initialized()
    path = tmp_path / "single_pod" / "llama3.2-1b__decode_32k.json"
    res = json.loads(path.read_text())
    assert res["status"] == "ok" and res["chips"] == 256
    assert res["mesh"] == {"data": 16, "model": 16}
    assert res["decode_pos"] == 32767
    assert res["cost_detail"]["no_cost_accounting"] is True
    assert res["memory"]["argument_size_bytes"] > 0
    assert res["memory"]["temp_size_bytes"] > 0
    for key in ("generated_code_size_bytes", "alias_size_bytes"):
        assert res["memory"][key] is None
    assert res["lower_s"] is None and res["compile_s"] is None
    assert set(dryrun.COLLECTIVES) < set(res["collectives"])
    assert "cuda_initialized=False" in capsys.readouterr().out
    path.write_text(json.dumps({**res, "marker": 1}))
    assert dryrun.main(argv) == {"ok": 0, "skip": 0, "fail": 0}
    assert "[cached]" in capsys.readouterr().out
    assert json.loads(path.read_text())["marker"] == 1
    assert dryrun.main(argv + ["--force"])["ok"] == 1
    assert "marker" not in json.loads(path.read_text())


def test_main_records_a_failure_and_exits_1(tmp_path, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("no rule")
    monkeypatch.setattr(dryrun, "run_cell", broken)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "llama3.2-1b", "--shape", "train_4k",
                     "--single-pod", "--out", str(tmp_path)])
    assert e.value.code == 1
    assert not dist.is_initialized()
    res = json.loads((tmp_path / "single_pod" /
                      "llama3.2-1b__train_4k.json").read_text())
    assert res == {"arch": "llama3.2-1b", "shape": "train_4k",
                   "status": "fail", "error": "RuntimeError: no rule"}


def test_an_override_the_port_reads_is_taken(tmp_path):
    cfg = dryrun.apply_overrides(tconfigs.get_config("mixtral-8x22b"),
                                 {"decode_no_fsdp": True})
    assert dataclasses.asdict(cfg)["decode_no_fsdp"] is True
    with pytest.raises(TypeError):
        dryrun.apply_overrides(cfg, {"no_such_knob": 1})
    # the loss reads ce_onehot on a mesh too (test_ce_onehot_on_a_mesh_*)
    assert dryrun.apply_overrides(cfg, {"ce_onehot": True}).ce_onehot is True


def test_ce_onehot_on_a_mesh_reduces_and_never_gathers_the_vocab(mesh2x2):
    """The smoke llama3.2-1b's train cell on the fake 2x2 world under both
    losses.  ``ce_onehot=False`` all-gathers a device's fp32 logits over
    the vocab (the reference's gather); ``True`` gathers no logits: its
    all-gather bytes are lower by exactly that gather, and it adds three
    all-reduces of a device's (B, S) fp32 values (the max, the sum of
    exponentials and the gold logit), none in the backward.  The FLOPs are
    one count under both."""
    cfg = tconfigs.get_smoke_config("llama3.2-1b")
    shape = SMALL["train"]
    got = {onehot: dryrun.run_cell(dataclasses.replace(cfg,
                                                       ce_onehot=onehot),
                                   shape, mesh2x2)
           for onehot in (False, True)}
    rows = shape.global_batch // 2 * shape.seq_len   # the batch over data
    logits = rows * cfg.padded_vocab * 4             # fp32, vocab whole
    off, on = (got[k]["collectives"] for k in (False, True))
    assert off["all-gather"] - on["all-gather"] == logits
    assert on["all-reduce"] - off["all-reduce"] == 3 * rows * 4
    assert on["count"] - off["count"] == 3 - 1
    for key in ("matmul_flops", "matmul_flops_per_device"):
        assert got[True][key] == got[False][key]


def test_a_norm_over_a_sharded_row_reduces_partial_sums(mesh2x2):
    """``layers.rmsnorm`` on meta DTensor rows (8, 16, 64), the batch over
    data and the normalised dim over model, w laid out as that dim: the
    forward issues one all-reduce, of a device's (4 * 16,) fp32 sums of
    squares; the backward one more of the same rows (the sums of x w g),
    and w's grad is left a partial sum over the rows' shards on data;
    neither gathers."""
    from repro_torch.models import layers

    m = mesh2x2
    x = _dt(m, (8, 16, 64), [Shard(0), Shard(2)]).requires_grad_()
    w = _dt(m, (64,), [Replicate(), Shard(0)]).requires_grad_()
    rows = 4 * 16
    with use_sharding(m):
        fwd = dryrun.StepCounter()
        with fwd:
            out = layers.rmsnorm(x, w, 1e-5)
        assert out.placements == x.placements and out.shape == x.shape
        bwd = dryrun.StepCounter()
        with bwd:
            dx, dw = torch.autograd.grad(out, (x, w), torch.ones_like(out))
    zero = {k: 0 for k in dryrun.COLLECTIVES if k != "all-reduce"}
    for counter in (fwd, bwd):
        assert counter.collectives == {**zero, "all-reduce": rows * 4,
                                       "count": 1}
    assert dx.placements == x.placements
    assert dw.placements == (Partial(), Shard(0))
