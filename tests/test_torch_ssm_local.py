"""The SSM families' sharded train and prefill steps run no op that DTensor
2.11 refuses (ROADMAP.md, Queue 3, fault G), on the CPU.

torch 2.11's DTensor stops at three of the ops that mamba2's and hymba's
sharded steps used to run on DTensors: ``aten.constant_pad_nd.default``
(``F.pad``; it cannot plan the redistribution of a tensor split on another
dim: ``IndexError`` in ``generate_greedy_transform_infos``),
``aten.flip.default`` (the backward of the SSD's ``cumsum``; "does not have
a sharding strategy registered") and the ``aten.view.default`` inside
``torch.matmul`` that merges the batch, split over ``data``, with the heads,
split over ``model`` ("Attempted to flatten multiple dimensions, with
dimension 2 being sharded").  The MoE models stop at three more:
``aten.scatter_.src`` in place on a tensor split over the batch, in the
routing ("in-place operations that require placement changes are not
supported"), ``aten.scatter.src`` in the backward of ``topk`` ("got mixed
torch.Tensor and DTensor") and ``aten.roll.default`` of a rolling cache
("does not have a sharding strategy registered").  A newer DTensor runs
them all, so the steps' values cannot show the fault here: a dispatch
mode records the ops that reach DTensor instead, in the smoke
mamba2-780m's and hymba-1.5b's train steps (with and without remat, and
with a tail short of a chunk) and prefills (at a length that ``ssm_chunk``
does not divide, so that the SSD pads its tail), and mixtral's and
moonshot's train, prefill and decode steps (mixtral's with its window's
ring buffer too), on meta DTensors of a fake 2x2 (data, model) world.
The SSD, the MoE's top-k and routing and a roll of the cache's slots run
on each rank's local shards (``models.mamba2.ssd_chunked``,
``layers.moe_ffn``, ``parallel.sharding.roll``) and hymba's prefill writes
its K and V into caches laid out by their names: none of those ops reaches
DTensor.  The world's matmul FLOPs of the same steps equal the
unsharded step's; without a mesh the SSD runs its old ops, bit for bit,
and hymba's prefill cache equals, bit for bit, the zero-padded K and V the
prefill used to return.

This file imports no JAX: it runs on a host that has torch alone.
"""
import dataclasses
import math

import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world
from repro_torch.models import get_model, make_prefill_step
from repro_torch.models.hybrid import KV_NAMES
from repro_torch.models.model_api import cache_tensor
from repro_torch.parallel.sharding import is_shard, use_sharding

aten = torch.ops.aten
B = 4
# case -> (arch, config changes, step kind, sequence length)
CASES = {
    "mamba2-train-remat": ("mamba2-780m", {"remat": True}, "train", 64),
    "mamba2-train": ("mamba2-780m", {"remat": False}, "train", 64),
    "mamba2-train-tail": ("mamba2-780m", {"remat": False}, "train", 40),
    "mamba2-prefill-tail": ("mamba2-780m", {}, "prefill", 40),
    # one SSD head (P = 128): whole on each model rank
    "mamba2-odd-train": ("mamba2-780m", {"ssm_state": 3, "ssm_head_dim": 128,
                                         "remat": False}, "train", 40),
    "hymba-train-remat": ("hymba-1.5b", {"remat": True}, "train", 64),
    "hymba-train": ("hymba-1.5b", {"remat": False}, "train", 64),
    "hymba-train-tail": ("hymba-1.5b", {"remat": False}, "train", 40),
    # past the 32-token window: the windowed layer keeps its last 32, the
    # global one is written into a cache of S + 64 slots
    "hymba-prefill-tail": ("hymba-1.5b", {}, "prefill", 40),
    "hymba-prefill-short": ("hymba-1.5b", {}, "prefill", 24),
    # the MoE's routing scatters in place (a rolling cache past mixtral's
    # 32-token window)
    "mixtral-train": ("mixtral-8x22b", {}, "train", 64),
    "mixtral-prefill": ("mixtral-8x22b", {}, "prefill", 40),
    "mixtral-decode": ("mixtral-8x22b", {}, "decode", 64),
    "moonshot-train": ("moonshot-v1-16b-a3b", {}, "train", 64),
    "moonshot-prefill": ("moonshot-v1-16b-a3b", {}, "prefill", 40),
    "moonshot-decode": ("moonshot-v1-16b-a3b", {}, "decode", 64),
    # the window's ring buffer rolls the prompt's K and V into place
    "mixtral-ring-prefill": ("mixtral-8x22b", {"swa_ring_buffer": True},
                             "prefill", 40),
    "mixtral-ring-decode": ("mixtral-8x22b", {"swa_ring_buffer": True},
                            "decode", 64),
}


@pytest.fixture
def mesh2x2():
    """A (data=2, model=2) mesh over a fake world of 4 ranks, destroyed
    after the test."""
    with fake_world(4):
        yield DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                         mesh_dim_names=("data", "model"))
    assert not dist.is_initialized()


def _cell(case: str):
    arch, changes, kind, seq = CASES[case]
    cfg = dataclasses.replace(tconfigs.get_smoke_config(arch), **changes)
    return cfg, tconfigs.ShapeSpec(case, kind, seq, B)


def _merged_split_dims(shape, pls, size) -> list:
    """The groups of dims of a tensor of ``shape`` laid out by ``pls``
    that a view to ``size`` merges into one dim, where two or more dims of
    the group are split (each over its own mesh dim)."""
    size = list(size)
    if -1 in size:
        size[size.index(-1)] = math.prod(shape) // -math.prod(size)
    ends = {math.prod(size[:j + 1]) for j in range(len(size))}
    split = {p.dim for p in pls if is_shard(p)}
    out, group = [], []
    for d in range(len(shape)):
        group.append(d)
        if math.prod(shape[:d + 1]) in ends and (
                d + 1 == len(shape) or shape[d + 1] != 1):
            if len(split.intersection(group)) > 1:
                out.append(tuple(group))
            group = []
    return out


def _refused(func, args) -> bool:
    """Whether torch 2.11's DTensor refuses ``func`` on ``args``, whose
    first DTensor is the op's input: ``aten.constant_pad_nd``,
    ``aten.flip`` and ``aten.roll`` of any DTensor, ``aten.scatter_`` in
    place (its rule keeps no split placement) and ``aten.scatter`` (the
    backward of ``topk``, whose zeros are a plain tensor under 2.11), and
    a ``view`` or ``_unsafe_view`` that merges dims split over two mesh
    dims."""
    packet = func._overloadpacket
    t = next(a for a in tree_leaves(args) if isinstance(a, DTensor))
    return packet in (aten.constant_pad_nd, aten.flip, aten.roll,
                      aten.scatter_, aten.scatter) or (
        packet in (aten.view, aten._unsafe_view)
        and bool(_merged_split_dims(t.shape, t.placements, args[1])))


class _RefusedOps(TorchDispatchMode):
    """Records, while open, each op on DTensors that ``_refused`` names:
    ``seen``, (op, global shape, placements) of each."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            if _refused(func, args):
                t = next(a for a in tree_leaves(args)
                         if isinstance(a, DTensor))
                self.seen.append((str(func), tuple(t.shape),
                                  tuple(t.placements)))
            return NotImplemented
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", sorted(CASES))
def test_no_op_the_card_hosts_dtensor_refuses_reaches_dtensor(mesh2x2,
                                                              case):
    """Fault G: the step runs on meta DTensors of the 2x2 world, and none
    of ``_RefusedOps``' ops reaches DTensor dispatch, forward or backward
    (remat's recompute included)."""
    cfg, shape = _cell(case)
    with use_sharding(mesh2x2):
        step, args, _ = dryrun.build_step_and_specs(cfg, shape)
        with _RefusedOps() as ops:
            out = step(*args)
    assert isinstance(tree_leaves(out)[0], DTensor)
    assert not ops.seen, sorted({(op, pls) for op, _, pls in ops.seen},
                                key=str)


def test_the_recorder_names_each_refused_op(mesh2x2):
    """``_refused`` names a pad, a flip, a roll and a scatter (in place or
    not) of a DTensor split over ``data``, and the view of a (data,
    model)-split tensor that merges the two split dims; not a view that
    merges one split dim with whole ones, nor a gather.  The ops are
    classified, not run: the card host's DTensor raises on them."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    x = distribute_tensor(torch.zeros(4, 6, 4, 2), mesh2x2,
                          [Shard(0), Shard(2)])
    b = distribute_tensor(torch.zeros(4, 6, 3), mesh2x2,
                          [Shard(0), Replicate()])
    idx = distribute_tensor(torch.zeros(4, 6, 3, dtype=torch.long), mesh2x2,
                            [Shard(0), Replicate()])
    assert _refused(aten.constant_pad_nd.default, (b, [0, 0, 0, 2], 0.0))
    assert _refused(aten.flip.default, (b, [1]))
    assert _refused(aten.scatter_.src, (b, 1, idx, b))
    assert _refused(aten.scatter.src, (b, 1, idx, b))
    assert _refused(aten.roll.default, (b, [-1], [1]))
    assert _refused(aten.view.default, (x, [96, 2]))
    assert _refused(aten._unsafe_view.default, (x, [-1, 2]))
    assert not _refused(aten.view.default, (x, [4, 6, 8]))
    assert not _refused(aten.gather.default, (b, 1, idx))
    assert _merged_split_dims((4, 6, 4, 2), x.placements, (96, 2)) == \
        [(0, 1, 2)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_world_flops_equal_the_unsharded_steps(mesh2x2, case):
    """The world's matmul FLOPs of the step on the 2x2 world equal the
    unsharded step's: the scan's body on local shards is counted once a
    distinct (batch, heads) piece, and the chunks' C . B products, which
    read no head, once for the world."""
    cfg, shape = _cell(case)
    got = dryrun.run_cell(cfg, shape, mesh2x2)
    want = dryrun.run_cell(cfg, shape, None)
    assert got["matmul_flops"] == want["matmul_flops"]
    assert got["matmul_flops_per_device"] < want["matmul_flops"]


@pytest.mark.parametrize("seq", [40, 24])
def test_hymba_prefill_cache_is_the_padded_one(seq):
    """Without a mesh, the K and V caches that hymba's prefill writes in
    place equal, bit for bit, each layer's K and V zero-padded to
    ``max_len`` (the windowed layer past its window: its last 32)."""
    cfg = tconfigs.get_smoke_config("hymba-1.5b")
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, seq),
                           generator=torch.Generator().manual_seed(1))
    max_len = seq + 64
    _, cache = model.prefill(params, {"tokens": tokens}, max_len)
    with torch.no_grad():
        layers = list(model._layers(params, tokens))
    for i, _, ((k, v), _) in layers:
        win = model.window(i)
        for got, want in ((cache["k"][i], k), (cache["v"][i], v)):
            if win is not None and seq >= win:
                want = want[:, :, -win:]
            else:
                want = F.pad(want, (0, 0, 0, max_len - seq))
            assert got.dtype == want.dtype
            assert torch.equal(got, want), (i, seq)


@pytest.mark.parametrize("seq", [40, 24])
def test_hymba_prefill_cache_keeps_its_shard_shape(mesh2x2, seq):
    """On the 2x2 world each layer's K and V from the prefill are laid out
    by ``KV_NAMES``: the placements and local shape that ``cache_tensor``
    gives a cache of their shape, as the decode steps write them in
    place.  The windowed layer past its window holds its last 32
    positions, any other layer ``max_len`` (S + 64)."""
    cfg = tconfigs.get_smoke_config("hymba-1.5b")
    shape = tconfigs.ShapeSpec("p", "prefill", seq, B)
    with use_sharding(mesh2x2):
        model = get_model(cfg)
        specs = tconfigs.input_specs(cfg, shape)
        _, cache = make_prefill_step(model)(model.abstract_params(),
                                            specs["batch"])
        for name in ("k", "v"):
            for i, got in enumerate(cache[name]):
                win = model.window(i)
                slots = win if win is not None and seq >= win else seq + 64
                assert got.shape == (B, cfg.n_kv_heads, slots, cfg.hd)
                ref = cache_tensor(tuple(got.shape), KV_NAMES, got.dtype,
                                   "meta")
                assert got.placements == ref.placements
                assert got.to_local().shape == ref.to_local().shape


def _old_ssd_chunked(x, dt, a_log, b, c, d_skip, chunk):
    """``ssd_chunked`` as it was written before it learned to run on local
    shards, without a mesh (where its ``shard_acts`` constraints and its
    mask's ``replicate_as`` return their inputs)."""
    bsz, L, H, P = x.shape
    N = b.shape[-1]
    L_orig = L
    if L % chunk:
        pad = chunk - L % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
        L += pad
    nc, q = L // chunk, chunk
    A = -torch.exp(a_log.float())
    dt = dt.float()
    xr = x.reshape(bsz, nc, q, H, P).float()
    br = b.reshape(bsz, nc, q, N).float()
    cr = c.reshape(bsz, nc, q, N).float()
    dtr = dt.reshape(bsz, nc, q, H)
    La = torch.cumsum(dtr * A, dim=2)
    Lh = La.transpose(2, 3)
    ii = torch.arange(q, device=x.device)
    causal = ii[:, None] >= ii[None, :]
    decay = torch.exp((Lh[..., :, None] - Lh[..., None, :]).masked_fill(
        ~causal, float("-inf")))
    cb = torch.einsum("bcin,bcjn->bcij", cr, br)
    w = cb[:, :, None] * decay * dtr.transpose(2, 3)[:, :, :, None, :]
    y_intra = torch.matmul(w, xr.transpose(2, 3))
    last = La[:, :, -1:, :]
    w_state = torch.exp(last - La) * dtr
    s_loc = torch.einsum("bcjn,bcjhp->bchnp", br, xr * w_state[..., None])
    g = torch.exp(last[:, :, 0, :])
    state = torch.zeros_like(s_loc[:, 0])
    entering = []
    for k in range(nc):
        entering.append(state)
        state = g[:, k, :, None, None] * state + s_loc[:, k]
    s_prev = torch.stack(entering, dim=1)
    y_inter = torch.einsum("bcin,bchnp->bchip", cr, s_prev) \
        * torch.exp(Lh)[..., None]
    y = (y_intra + y_inter).transpose(2, 3).reshape(bsz, L, H, P)
    y = y + d_skip.float()[None, None, :, None] * x.float()
    return y[:, :L_orig].to(x.dtype), state


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("L", [40, 32], ids=["tail", "no_tail"])
def test_the_ssd_without_a_mesh_is_its_old_ops_bit_for_bit(L, dtype):
    """Without a mesh ``ssd_chunked`` runs the ops it ran before: y, the
    final state and the grads of its six inputs equal, bit for bit, those
    of ``_old_ssd_chunked`` (x, B and C in ``dtype``, as the branch hands
    them over; dt and the scalars a head in fp32)."""
    from repro_torch.models.mamba2 import ssd_chunked

    gen = torch.Generator().manual_seed(3)
    H, P, N = 4, 8, 8

    def normal(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen).to(dtype)

    args = [normal(2, L, H, P, dtype=dtype),
            F.softplus(normal(2, L, H)), 0.5 * normal(H),
            normal(2, L, N, dtype=dtype), normal(2, L, N, dtype=dtype),
            normal(H)]
    gy, gs = normal(2, L, H, P), normal(2, H, N, P)
    outs = []
    for fn in (ssd_chunked, _old_ssd_chunked):
        ins = [a.clone().requires_grad_() for a in args]
        y, state = fn(*ins, chunk=16)
        ((y.float() * gy).sum() + (state * gs).sum()).backward()
        outs.append([y, state, *(t.grad for t in ins)])
    for got, want in zip(*outs, strict=True):
        assert got.dtype == want.dtype
        assert torch.equal(got, want)
