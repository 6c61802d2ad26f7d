"""The port's model steps on real DTensors, sharded over a 4-rank gloo world
as a (data=2, model=2) mesh, against the port's unsharded steps and the JAX
package's, on the same weights and inputs, on the CPU.

The weights are JAX's (``init(PRNGKey(0))``), carried over through
``convert.params_from_numpy``; the inputs come from numpy with a seed.  One
module-scoped spawn of 4 ranks runs, for each case, a prefill of B = 4
prompts, 3 decode steps into the placed cache and two
``make_train_step``s, the second on the first's outputs, all under
``use_sharding(mesh)``, and writes each output's
``full_tensor()``; meanwhile this process runs the same steps unsharded and
JAX's jitted steps.  GSPMD does not change values, so the JAX package's
unsharded run is the reference.  The kernels take their plain versions on
the CPU, on each rank's local shards (``parallel.sharding.
on_local_shards``).

The cases: the smoke llama3.2-1b (4 q and 2 kv heads: both shard over
``model``), mixtral-8x22b (MoE; a 40-token prompt past its 32-token window,
so the cache rolls; its 4 experts split over ``model``, and with 3, which
``model`` does not divide, the experts' F split instead: the dispatch,
the expert up- and down-projections and the combine run on each rank's
slice, faults J and K; that case under remat too),
moonshot-v1-16b-a3b (the second MoE family), mamba2-780m (across a chunk edge; and with blocks of
in_proj that do not divide ``model``), hymba-1.5b (a
positional global layer beside a rolling windowed one), and llama3.2-1b
with 1 kv head (q heads sharded, the kv head whole on every model rank; the
cache's slots shard over ``model``, so decode combines its softmax across
them) and with 6 q over 3 kv heads (a rank's q heads span two kv heads);
minicpm-2b (its LM head the embedding table, tied: fault L's lookup on
local shards and the table's grad of both uses); with one kv head too,
serving only, mixtral's shifted and ring-buffer
caches and hymba's caches, their slots sharded over ``model``; llama3.2-1b
and hymba-1.5b recomputing each layer in the train step's backward (remat,
under ``"nothing"`` and for llama ``"dots"`` too; the other cases and JAX
run without, which changes no value); llama3.2-1b with ``ce_onehot``, the
vocab-parallel cross-entropy, whole and in two loss chunks under remat;
and hubert-xlarge's encode.  The ranks also count the all-gathers of
activations around each call of the loss and the norms: none under
``ce_onehot``, none in the norms of mamba2's and hymba's split rows.  And
they run ``mamba2.ssd_chunked`` alone on its local shards (fault G), heads
split over ``model`` and whole on each rank, with a tail short of a chunk
and without: y, the final state and the grads of its six inputs against
the unsharded port and ``jax.grad`` of the reference's.  And a product run
by ``on_local_shards`` on each rank's piece of its contraction, whose
output is a ``Partial`` sum: the grad it takes is the whole cotangent,
replicated (fault J).

Every run takes fp32 activations (the port's ``ACT_DTYPE``, JAX's ``jnp``
read with bfloat16 as float32, as tests/test_torch_train.py runs its fp32
steps).  In bf16 the sharded program's other summation order moves a value
by a few ulps, past the one-ulp cache bound; it flips a near tie of the
MoE's top-k routing, discontinuous in either package (ROADMAP.md, Queue
3); and it flips the sign of a tiny grad, which AdamW's first step turns
into a whole step of the parameter.  In fp32 each quantity is held at
tests/test_torch_train.py's fp32 bound, rtol 1e-4 and atol 1e-5, against
both references: the logits and caches after the prefill and each decode
step and, after each train step, the loss, the grad norm, the first
moments and the parameters after AdamW.  That is tighter
than test_torch_models.py's bf16 bounds (logits 3e-2, caches one bf16
ulp).  The card's one-rank mesh holds the bf16 run (``chip_smoke.py``'s
``sharded`` phase).
"""
import collections
import contextlib
import dataclasses
import math
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.utils._python_dispatch import TorchDispatchMode
from torch.distributed.tensor import Shard
from torch.utils._pytree import tree_leaves

from repro_torch.configs import get_smoke_config
from repro_torch.models import (get_model, make_decode_step,
                                make_encode_step, make_prefill_step,
                                make_train_step)
from repro_torch.models.convert import params_from_numpy
from repro_torch.optimizer import adamw_init
from repro_torch.parallel.sharding import place, use_sharding

B, DECODE_STEPS, WORLD = 4, 3, 4
# the names of the train steps a case takes, each on the last's outputs
TRAIN_STEPS = ("train", "train2")
RANKS_TIMEOUT_S = 600
# case -> (arch, config changes, prompt length, whether it trains a step)
CASES = {
    "llama3.2-1b": ("llama3.2-1b", {}, 16, True),
    "mixtral-8x22b": ("mixtral-8x22b", {}, 40, True),
    # 3 experts, which model does not divide: the experts' hidden is split
    # over F, and the down-projection and the combine run on each rank's
    # F slice (fault J); the 4 of mixtral's smoke config are split over E
    "mixtral-ff-split": ("mixtral-8x22b", {"n_experts": 3}, 40, True),
    # the second MoE family, its 8 experts split over model
    "moonshot-v1-16b-a3b": ("moonshot-v1-16b-a3b", {}, 40, True),
    # the F-split MoE recomputing each layer in the backward (remat): the
    # dispatch's and the up-projections' body on local shards, whose
    # backward gathers the slots' tokens again (fault K), runs again too
    "mixtral-ff-remat": ("mixtral-8x22b", {"n_experts": 3, "remat": True},
                         40, True),
    "mamba2-780m": ("mamba2-780m", {}, 24, True),
    "hymba-1.5b": ("hymba-1.5b", {}, 40, True),
    "llama-1kv": ("llama3.2-1b", {"n_kv_heads": 1}, 16, True),
    "llama-6q3kv": ("llama3.2-1b", {"n_heads": 6, "n_kv_heads": 3}, 16,
                    True),
    # the train step recomputing each layer (remat): the norms' and
    # attention's bodies on local shards run again in the backward
    "llama-remat": ("llama3.2-1b", {"remat": True}, 16, True),
    "llama-remat-dots": ("llama3.2-1b", {"remat": True,
                                         "remat_policy": "dots"}, 16, True),
    "hymba-remat": ("hymba-1.5b", {"remat": True}, 40, True),
    # blocks that do not divide model: B and C (3 columns) and dt (one
    # head) each their own product, whole on each rank, x gathered for the
    # one head, the conv state's columns gathered to and from the blocks
    "mamba2-odd": ("mamba2-780m", {"ssm_state": 3, "ssm_head_dim": 128},
                   24, True),
    # the vocab-parallel cross-entropy: each rank's vocab shard reduced,
    # (B, S) all-reduces, no logits gathered; whole and in 2 chunks under
    # remat (each chunk's loss recomputed in the backward)
    "llama-onehot": ("llama3.2-1b", {"ce_onehot": True}, 16, True),
    "llama-onehot-chunk": ("llama3.2-1b", {"ce_onehot": True,
                                           "logits_chunk": 2,
                                           "remat": True}, 16, True),
    # one kv head: the rolling caches' slots shard over model
    "mixtral-1kv": ("mixtral-8x22b", {"n_kv_heads": 1}, 40, False),
    "mixtral-1kv-ring": ("mixtral-8x22b", {"n_kv_heads": 1,
                                           "swa_ring_buffer": True}, 40,
                         False),
    "hymba-1kv": ("hymba-1.5b", {"n_kv_heads": 1}, 40, False),
    # a tied table (the LM head is the embedding's transpose): the lookup
    # on local shards, the table's grad the lookup's and the head's, summed
    # before its one reduction (fault L)
    "minicpm-2b": ("minicpm-2b", {}, 16, True),
}
ENCODER, ENCODE_FRAMES = "hubert-xlarge", 24
# case -> the calls that must gather no activation on the mesh: the loss
# under ce_onehot, the norms where their rows are split (mamba2's gated
# norm over ff, hymba's branch norms over the heads), which reduce partial
# sums of squares instead
NO_GATHER = {"llama-onehot": "loss", "llama-onehot-chunk": "loss",
             "mamba2-780m": "norm", "hymba-1.5b": "norm",
             "hymba-remat": "norm"}

TOL = dict(rtol=1e-4, atol=1e-5)   # every quantity, fp32 activations

# ``mamba2.ssd_chunked`` alone, on local shards: case -> (heads, length).
# 4 heads split over model, 3 whole on each model rank; 40 positions end
# in a tail short of the 16-position chunk, 32 do not
SSD_CASES = {"ssd-heads-split": (4, 40), "ssd-heads-whole": (3, 40),
             "ssd-heads-split-no-tail": (4, 32)}
SSD_P, SSD_N, SSD_CHUNK = 8, 8, 16
# each argument's logical names, and the cotangents' (y's, the state's)
SSD_ARGS = {"x": ("batch", "seq", "act_heads", None),
            "dt": ("batch", "seq", "act_heads"), "a_log": (None,),
            "b": ("batch", "seq", None), "c": ("batch", "seq", None),
            "d_skip": (None,)}
SSD_COTANGENTS = {"gy": SSD_ARGS["x"], "gs": ("batch", "act_heads", None,
                                              None)}
# ``on_local_shards`` with a ``Partial`` output: a @ b, the contraction
# split over model, a's rows over data; (rows, contraction, columns)
PARTIAL_CASE, PARTIAL_SHAPE = "partial-output", (B, 6, 5)


@contextlib.contextmanager
def _fp32_activations():
    """The port's models in fp32 activations while open."""
    from repro_torch.models import hybrid, mamba2, transformer

    with pytest.MonkeyPatch.context() as mp_:
        for mod in (transformer, mamba2, hybrid):
            mp_.setattr(mod, "ACT_DTYPE", torch.float32)
        yield


def _config(case: str):
    """``case``'s smoke config, without remat unless the case asks."""
    arch, changes, *_ = CASES.get(case, (case, {}))
    return dataclasses.replace(get_smoke_config(arch),
                               **{"remat": False, **changes})


def _inputs(case: str) -> dict:
    """Numpy inputs from a seed: the prompt, one token a decode step, the
    train batch; frames for the encoder."""
    cfg = _config(case)
    rng = np.random.default_rng(11)
    if case == ENCODER:
        return {"frames": rng.standard_normal(
            (B, ENCODE_FRAMES, cfg.d_model)).astype(np.float32)}
    s = CASES[case][2]
    t = rng.integers(0, cfg.vocab_size, (B, s + DECODE_STEPS)
                     ).astype(np.int32)
    return {"prompt": t[:, :s], "steps": [t[:, s + i:s + i + 1]
                                          for i in range(DECODE_STEPS)],
            "train": {"tokens": t[:, :s], "targets": t[:, 1:s + 1]}}


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        if hasattr(t, "full_tensor"):
            t = t.full_tensor()
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _cache_leaves(cache: dict):
    """(name, tensor) of a cache's tensors, ``pos`` apart: a tuple of a
    layer each (hymba's k and v) by index."""
    for k in sorted(cache):
        if k == "pos":
            continue
        v = cache[k]
        if isinstance(v, (tuple, list)):
            yield from ((f"{k}.{i}", t) for i, t in enumerate(v))
        else:
            yield k, v


def _record(out: dict, step: str, logits, cache) -> None:
    out[f"{step}.logits"] = _np(logits)
    out[f"{step}.pos"] = np.asarray(int(cache["pos"]))
    for name, t in _cache_leaves(cache):
        out[f"{step}.cache.{name}"] = _np(t)
        if hasattr(t, "to_local"):
            out[f"shape:{step}.{name}"] = np.asarray(t.to_local().shape)


def _port_steps(case: str, arrays: dict, mesh=None) -> dict:
    """The port's steps of ``case`` on ``arrays`` under ``mesh`` (None:
    unsharded): {name: full numpy array}, and under a mesh each cache
    tensor's local shape after each step (``shape:...``) beside the one
    its names give (``want:...``)."""
    cfg = _config(case)
    model = get_model(cfg)
    x = _inputs(case)
    out = {}
    with use_sharding(mesh):
        params = model.place(params_from_numpy(arrays, "cpu"))
        if case == ENCODER:
            frames = place(torch.from_numpy(x["frames"]),
                           ("batch", "seq", None))
            out["encode.logits"] = _np(make_encode_step(model)(
                params, {"frames": frames}))
            return out

        def tok(a):
            return place(torch.from_numpy(a), ("batch", "seq"))

        logits, cache = make_prefill_step(model)(
            params, {"tokens": tok(x["prompt"])})
        _record(out, "prefill", logits, cache)
        for i, t in enumerate(x["steps"]):
            logits, cache = make_decode_step(model)(params, tok(t), cache)
            _record(out, f"decode{i}", logits, cache)
        if mesh is not None:
            s = x["prompt"].shape[1]
            for name, t in _cache_leaves(model.init_cache(B, s + 64,
                                                          device="meta")):
                out[f"want:{name}"] = np.asarray(t.to_local().shape)
        if not CASES[case][3]:
            return out
        train_step = make_train_step(model)
        batch = {k: tok(v) for k, v in x["train"].items()}
        opt = adamw_init(params)
        for step in TRAIN_STEPS:
            # the second step takes the first's outputs, as a run does
            params, opt, metrics = train_step(params, opt, batch)
            _record_train(out, step, params, opt, metrics)
    return out


def _record_train(out: dict, step: str, params: dict, opt, metrics: dict
                  ) -> None:
    for k in ("loss", "grad_norm"):
        out[f"{step}.{k}"] = _np(metrics[k])
    for k in params:
        out[f"{step}.params.{k}"] = _np(params[k])
        out[f"{step}.mu.{k}"] = _np(opt.mu[k])


# the (global shape, placements) of each DTensor that DTensor is
# redistributing, innermost last (``_naming_redistributions``)
_REDISTRIBUTING: list = []


class _Gathers(TorchDispatchMode):
    """Counts, while open, the all-gathers DTensor issues (on the local
    tensors) whose results are floating point with two dims or more:
    activations, where a norm's weight has one dim and token ids are
    integers.  Also keeps, for each, the (global shape, placements) of the
    DTensor whose redistribution issued it (None where none was under
    way) and the bytes it gathered: ``seen``."""

    def __init__(self):
        super().__init__()
        self.n = 0
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if func._overloadpacket in (
                torch.ops._c10d_functional.all_gather_into_tensor,
                torch.ops._c10d_functional.all_gather_into_tensor_coalesced):
            for t in tree_leaves(out):
                if t.dim() >= 2 and t.is_floating_point():
                    self.n += 1
                    self.seen.append((_REDISTRIBUTING[-1] if
                                      _REDISTRIBUTING else None,
                                      t.numel() * t.element_size()))
        return out


@contextlib.contextmanager
def _naming_redistributions():
    """While open, DTensor's redistributions (of an op's inputs, and
    ``redistribute``'s) push the (global shape, placements) of the DTensor
    they move onto ``_REDISTRIBUTING`` while they run."""
    import torch.distributed.tensor._dispatch as dispatch
    import torch.distributed.tensor._redistribute as redistribute

    orig = redistribute.redistribute_local_tensor

    def named(local, current_spec, *args, **kwargs):
        _REDISTRIBUTING.append((tuple(current_spec.shape),
                                tuple(current_spec.placements)))
        try:
            return orig(local, current_spec, *args, **kwargs)
        finally:
            _REDISTRIBUTING.pop()

    with pytest.MonkeyPatch.context() as mp_:
        for mod in (dispatch, redistribute):
            mp_.setattr(mod, "redistribute_local_tensor", named)
        yield


def _ssm_account(g: _Gathers, h, step: bool, d_inner: int, n: int,
                 head_dim: int, **_) -> dict:
    """What one call of the SSM branch on ``h`` gathered (``g``), against
    what it may gather.  An activation is a tensor whose first dim is the
    batch, split over ``data``; the weights' gathers (over ``model``, and
    FSDP's over ``data``) are left out.  ``bad``: gathers of an activation
    of the in_proj output's or the conv output's shape; ``unknown``:
    gathers issued by no redistribution.  ``bytes``: the activations
    gathered; ``allow``: B and C, and where the SSD heads do not divide
    ``model`` x and dt whole on each rank, and in a decode step x and dt,
    which the SSD cache's layout replicates."""
    mesh = h.device_mesh
    names = list(mesh.mesh_dim_names)
    data, T = (mesh.size(names.index(a)) for a in ("data", "model"))
    lead = tuple(h.shape[:-1])
    H = d_inner // head_dim
    conv_dim, d_in_proj = d_inner + 2 * n, 2 * d_inner + 2 * n + H
    rows = math.prod(lead) // data
    padded = -(-H // T) * T
    if step:
        allow = d_inner + 2 * n + padded
    else:
        allow = 2 * n + (d_inner + padded if H % T else 0)
    out = {"bad": 0, "unknown": 0, "bytes": 0,
           "allow": rows * allow * h.element_size()}
    for spec, nbytes in g.seen:
        if spec is None:
            out["unknown"] += 1
            continue
        shape, pls = spec
        batch = pls[names.index("data")]
        if shape[0] != lead[0] or type(batch) is not Shard or batch.dim:
            continue   # a weight
        out["bad"] += shape in (lead + (d_in_proj,), lead + (conv_dim,))
        out["bytes"] += nbytes
    return out


@contextlib.contextmanager
def _counting_gathers(counts: dict):
    """While open, every call of the models' cross-entropy and norms runs
    under a ``_Gathers``, which adds to ``counts["loss"]`` and
    ``counts["norm"]`` (a recomputed norm or loss chunk in the backward
    too); every call of the SSM branch (``mamba2.ssm_branch_full`` and
    ``ssm_branch_step``, mamba2's and hymba's) to ``counts["ssm"]``, and
    its ``_ssm_account`` to ``counts["ssm:<key>"]``."""
    from repro_torch.models import hybrid, mamba2, transformer

    def counted(fn, key):
        def call(*args, **kwargs):
            with _Gathers() as g:
                out = fn(*args, **kwargs)
            counts[key] += g.n
            if key == "ssm":
                for k, v in _ssm_account(
                        g, args[0], fn.__name__ == "ssm_branch_step",
                        **kwargs).items():
                    counts[f"ssm:{k}"] += v
            return out
        return call

    with pytest.MonkeyPatch.context() as mp_, _naming_redistributions():
        for mod in (transformer, mamba2, hybrid):
            for name, key in (("lm_cross_entropy", "loss"),
                              ("rmsnorm", "norm")):
                mp_.setattr(mod, name, counted(getattr(mod, name), key))
        for mod in (mamba2, hybrid):
            for name in ("ssm_branch_full", "ssm_branch_step"):
                mp_.setattr(mod, name, counted(getattr(mod, name), "ssm"))
        yield


def _ssd_inputs(case: str) -> dict:
    """Numpy inputs of ``ssd_chunked`` from a seed (dt softplus'd), and the
    cotangents of y and the final state."""
    H, L = SSD_CASES[case]
    rng = np.random.default_rng(5)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"x": normal(B, L, H, SSD_P),
            "dt": np.logaddexp(0, normal(B, L, H)).astype(np.float32),
            "a_log": 0.5 * normal(H), "b": normal(B, L, SSD_N),
            "c": normal(B, L, SSD_N), "d_skip": normal(H),
            "gy": normal(B, L, H, SSD_P), "gs": normal(B, H, SSD_N, SSD_P)}


def _port_ssd(case: str, mesh=None) -> dict:
    """``mamba2.ssd_chunked`` of ``case`` under ``mesh`` (None: unsharded):
    y, the final state and the grads of its six arguments of the loss
    sum(y * gy) + sum(state * gs), each gathered; under a mesh y's and the
    state's local shapes (``shape:...``)."""
    from repro_torch.models.mamba2 import ssd_chunked

    arrays = _ssd_inputs(case)
    out = {}
    with use_sharding(mesh):
        ins = {k: place(torch.from_numpy(arrays[k]), names).detach()
               .requires_grad_() for k, names in SSD_ARGS.items()}
        gy, gs = (place(torch.from_numpy(arrays[k]), names)
                  for k, names in SSD_COTANGENTS.items())
        y, state = ssd_chunked(*ins.values(), chunk=SSD_CHUNK)
        ((y * gy).sum() + (state * gs).sum()).backward()
    out["y"], out["state"] = _np(y), _np(state)
    out.update({f"grad.{k}": _np(t.grad) for k, t in ins.items()})
    if mesh is not None:
        for k, t in (("y", y), ("state", state)):
            out[f"shape:{k}"] = np.asarray(t.to_local().shape)
    return out


def _jax_ssd(case: str) -> dict:
    """``repro.models.mamba2.ssd_chunked`` of ``case`` in fp32: y, the final
    state and ``jax.grad`` of ``_port_ssd``'s loss."""
    import jax
    import jax.numpy as jnp

    from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked

    arrays = _ssd_inputs(case)

    def loss(*args):
        y, state = jax_ssd_chunked(*args, chunk=SSD_CHUNK)
        return ((y * arrays["gy"]).sum() + (state * arrays["gs"]).sum(),
                (y, state))

    grads, (y, state) = jax.jit(jax.grad(
        loss, argnums=tuple(range(len(SSD_ARGS))), has_aux=True))(
        *(jnp.asarray(arrays[k]) for k in SSD_ARGS))
    return {"y": _np(y), "state": _np(state),
            **{f"grad.{k}": _np(g) for k, g in zip(SSD_ARGS, grads)}}


def _partial_inputs() -> dict:
    """a, b and the cotangent g of a @ b, from a seed."""
    n, k, m = PARTIAL_SHAPE
    rng = np.random.default_rng(9)
    return {name: rng.standard_normal(shape).astype(np.float32)
            for name, shape in (("a", (n, k)), ("b", (k, m)),
                                ("g", (n, m)))}


def _port_partial(mesh=None) -> dict:
    """a @ b and the grads of a and b of the loss sum((a @ b) * g).  Under
    ``mesh`` the product runs in ``on_local_shards`` on each rank's piece
    of the contraction (a's columns and b's rows split over model, a's
    rows over data) and comes out a ``Partial`` sum over model, reduced
    after; ``cotangent_is_g`` says whether the grad that the body's product
    received on this rank equals its rows of g, whole over model."""
    from torch.distributed.tensor import (Partial, Replicate, Shard,
                                          distribute_tensor)

    from repro_torch.parallel.sharding import on_local_shards

    arrays = _partial_inputs()
    a, b, g = (torch.from_numpy(arrays[k]) for k in "abg")
    out = {}
    if mesh is None:
        a, b = a.requires_grad_(), b.requires_grad_()
        y = a @ b
    else:
        a, b, g = (distribute_tensor(t, mesh, pls, src_data_rank=None)
                   for t, pls in ((a, [Shard(0), Shard(1)]),
                                  (b, [Replicate(), Shard(0)]),
                                  (g, [Shard(0), Replicate()])))
        a, b = a.requires_grad_(), b.requires_grad_()
        seen = []

        def body(al, bl):
            p = al @ bl
            p.register_hook(seen.append)
            return p + 0

        y, = on_local_shards(body, [(a, a.placements), (b, b.placements)],
                             [[Shard(0), Partial()]])
        y = y.redistribute(mesh, [Shard(0), Replicate()])
    (y * g).sum().backward()
    if mesh is not None:
        out["cotangent_is_g"] = np.asarray(
            len(seen) == 1 and torch.equal(seen[0], g.to_local()))
    out.update({"y": _np(y), "grad.a": _np(a.grad), "grad.b": _np(b.grad)})
    return out


def _jax_partial() -> dict:
    """jnp's a @ b and ``jax.grad`` of ``_port_partial``'s loss."""
    import jax
    import jax.numpy as jnp

    arrays = _partial_inputs()
    a, b = (jnp.asarray(arrays[k]) for k in "ab")
    ga, gb = jax.grad(lambda a, b: ((a @ b) * arrays["g"]).sum(),
                      argnums=(0, 1))(a, b)
    return {"y": _np(a @ b), "grad.a": _np(ga), "grad.b": _np(gb)}


def _rank_main(rank: int, tmp: str) -> None:
    """One of the 4 gloo ranks: every case on the (data, model) mesh,
    written to ``rank{rank}_{case}.npz``."""
    from torch.distributed.device_mesh import DeviceMesh

    torch.set_num_threads(1)
    tmp = Path(tmp)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp / "store"), WORLD), rank=rank, world_size=WORLD)
    try:
        mesh = DeviceMesh("cpu", torch.arange(WORLD).reshape(2, 2),
                          mesh_dim_names=("data", "model"))
        with _fp32_activations():
            for case in (*CASES, ENCODER):
                w = dict(np.load(tmp / f"weights_{case}.npz"))
                counts = collections.Counter(loss=0, norm=0, ssm=0)
                with _counting_gathers(counts):
                    out = _port_steps(case, w, mesh)
                out.update({k if ":" in k else f"gathers:{k}": np.asarray(n)
                            for k, n in counts.items()})
                np.savez(tmp / f"rank{rank}_{case}.npz", **out)
        for case in SSD_CASES:
            np.savez(tmp / f"rank{rank}_{case}.npz",
                     **_port_ssd(case, mesh))
        np.savez(tmp / f"rank{rank}_{PARTIAL_CASE}.npz",
                 **_port_partial(mesh))
    finally:
        dist.destroy_process_group()


def _jax_model(case: str):
    """(JAX's model of ``case``, its weights ``init(PRNGKey(0))``)."""
    import jax

    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import get_model as jax_get_model

    arch, changes, *_ = CASES.get(case, (case, {}))
    jm = jax_get_model(dataclasses.replace(jax_smoke_config(arch),
                                           **{**changes, "remat": False}))
    return jm, jm.init(jax.random.PRNGKey(0))


def _jax_steps(case: str, jm, jp) -> dict:
    """JAX's jitted steps of ``case`` on ``jp`` in fp32 activations, under
    the names of ``_port_steps``."""
    import jax
    import jax.numpy as jnp
    from test_torch_autograd import _Float32Jnp

    import repro.models.hybrid as jax_hybrid
    import repro.models.mamba2 as jax_mamba2
    import repro.models.transformer as jax_transformer
    from repro.models import make_train_step as jax_make_train_step
    from repro.optimizer import adamw_init as jax_adamw_init

    x = _inputs(case)
    out = {}

    def record(step, logits, cache):
        out[f"{step}.logits"] = _np(logits)
        out[f"{step}.pos"] = np.asarray(int(cache["pos"]))
        for name, t in _cache_leaves(cache):
            out[f"{step}.cache.{name}"] = _np(t)

    with pytest.MonkeyPatch.context() as patch:
        for mod in (jax_transformer, jax_mamba2, jax_hybrid):
            patch.setattr(mod, "jnp", _Float32Jnp())
        if case == ENCODER:
            out["encode.logits"] = _np(jax.jit(jm.forward)(
                jp, {"frames": jnp.asarray(x["frames"])}))
            return out
        logits, cache = jax.jit(jm.prefill)(
            jp, {"tokens": jnp.asarray(x["prompt"])})
        record("prefill", logits, cache)
        decode = jax.jit(jm.decode_step)
        for i, t in enumerate(x["steps"]):
            logits, cache = decode(jp, jnp.asarray(t), cache)
            record(f"decode{i}", logits, cache)
        if not CASES[case][3]:
            return out
        train_step = jax.jit(jax_make_train_step(jm))
        batch = {k: jnp.asarray(v) for k, v in x["train"].items()}
        opt = jax_adamw_init(jp)
        for step in TRAIN_STEPS:
            jp, opt, metrics = train_step(jp, opt, batch)
            _record_train(out, step, jp, opt, metrics)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory) -> dict:
    """case -> {"sharded": rank 0's outputs, "port": the unsharded port's,
    "jax": JAX's}.  JAX's weights are written first; the ranks then run
    while this process computes both references."""
    tmp = tmp_path_factory.mktemp("sharded4")
    models = {case: _jax_model(case) for case in (*CASES, ENCODER)}
    for case, (_, jp) in models.items():
        np.savez(tmp / f"weights_{case}.npz",
                 **{k: np.asarray(v) for k, v in jp.items()})
    ranks = mp.start_processes(_rank_main, args=(str(tmp),), nprocs=WORLD,
                               join=False, start_method="spawn")
    out = {}
    with _fp32_activations():
        for case, (jm, jp) in models.items():
            out[case] = {"jax": _jax_steps(case, jm, jp), "port": _port_steps(
                case, {k: np.asarray(v) for k, v in jp.items()})}
    for case in SSD_CASES:
        out[case] = {"jax": _jax_ssd(case), "port": _port_ssd(case)}
    out[PARTIAL_CASE] = {"jax": _jax_partial(), "port": _port_partial()}
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    while not ranks.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ranks.processes:
                p.kill()
            raise TimeoutError(f"the {WORLD} ranks ran past "
                               f"{RANKS_TIMEOUT_S} s")
    for case in out:
        got = [dict(np.load(tmp / f"rank{r}_{case}.npz"))
               for r in range(WORLD)]
        for other in got[1:]:   # every rank gathers the same full tensors
            assert other.keys() == got[0].keys()
            assert all(np.array_equal(other[k], got[0][k]) for k in other)
        out[case]["sharded"] = got[0]
    return out


def _steps() -> list[str]:
    return ["prefill"] + [f"decode{i}" for i in range(DECODE_STEPS)]


def _assert_close(runs: dict, case: str, names: list) -> None:
    """Each of ``names`` in the sharded run, gathered, against the port's
    unsharded run and JAX's, at ``TOL``."""
    got, port, want = (runs[case][k] for k in ("sharded", "port", "jax"))
    assert names
    for k in names:
        np.testing.assert_allclose(got[k], want[k], **TOL,
                                   err_msg=f"{k} against JAX")
        np.testing.assert_allclose(got[k], port[k], **TOL,
                                   err_msg=f"{k} against the port unsharded")


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_and_decode_match_unsharded_and_jax(runs, case):
    """Each step's logits, cache and ``pos``."""
    want = runs[case]["jax"]
    names = sorted(k for k in want if k.split(".")[0] in _steps())
    assert names == sorted(k for k in runs[case]["sharded"] if
                           not k.startswith(("shape:", "want:", "train",
                                             "gathers:", "ssm:")))
    _assert_close(runs, case, names)
    assert int(want["decode2.pos"]) == CASES[case][2] + DECODE_STEPS


@pytest.mark.parametrize("case,step", [
    pytest.param(c, step, id=c if step == TRAIN_STEPS[0] else f"{c}-{step}")
    for step in TRAIN_STEPS for c in sorted(c for c in CASES if CASES[c][3])])
def test_train_step_matches_unsharded_and_jax(runs, case, step):
    """Two ``make_train_step``s from the same weights, the second on the
    first's outputs (the sharded run's params and moments in the
    placements the first took): after each, the loss, the grad norm, the
    first moments ((1 - b1) times the clipped grads after the first step)
    and the parameters after AdamW."""
    want = runs[case]["jax"]
    names = sorted(k for k in want if k.startswith(f"{step}."))
    assert names == sorted(k for k in runs[case]["sharded"]
                           if k.startswith(f"{step}."))
    _assert_close(runs, case, names)


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_cache_keeps_its_shard_shape_at_every_step(runs, case):
    """After the prefill and each decode step every cache tensor on a rank
    has the local shape its logical names give (``init_cache`` on meta
    under the mesh): the cache is placed, written in place and never left
    gathered."""
    got = runs[case]["sharded"]
    want = {k.split(":", 1)[1]: v for k, v in got.items()
            if k.startswith("want:")}
    assert want
    for step in _steps():
        for name, shape in want.items():
            assert list(got[f"shape:{step}.{name}"]) == list(shape), \
                (step, name)
    if case == "llama-1kv":
        # one kv head: the slots shard over model, the batch over data
        assert list(want["k"]) == [2, B // 2, 1, (16 + 64) // 2, 16]
    if case.startswith("mixtral-1kv"):
        # a rolling cache of the window's 32 slots, 16 on each model rank
        assert list(want["k"]) == [2, B // 2, 1, 32 // 2, 16]


@pytest.mark.parametrize("case", sorted(NO_GATHER))
def test_no_logits_and_no_norm_row_are_gathered(runs, case):
    """Around the loss (``ce_onehot``: the vocab-parallel cross-entropy)
    and the norms (rows split over model: partial sums of squares), in the
    prefill, the decode steps and the train step with its backward's
    recompute, no activation is all-gathered; the counter sees the
    default loss's gather of the logits, the reference's program."""
    assert int(runs[case]["sharded"][f"gathers:{NO_GATHER[case]}"]) == 0
    assert int(runs["llama3.2-1b"]["sharded"]["gathers:loss"]) > 0


def test_encode_matches_unsharded_and_jax(runs):
    """hubert-xlarge's encode (the frames frontend, attention not
    causal)."""
    _assert_close(runs, ENCODER, ["encode.logits"])


# the SSM cases whose blocks all divide model (mamba2-odd's gather what
# does not)
SSM_CASES = sorted(c for c in CASES if CASES[c][0] in ("mamba2-780m",
                                                        "hymba-1.5b")
                   and c != "mamba2-odd")


@pytest.mark.parametrize("case", SSM_CASES)
def test_the_ssm_branch_gathers_no_projection_and_no_conv_output(runs,
                                                                  case):
    """Fault F: in the prefill, the decode steps and the train step (with
    remat's recompute where the case asks), the SSM branch gathers no
    tensor of in_proj's output's shape or the conv's output's: in_proj's
    blocks and the conv's outputs stay split over ``model``.  It gathers
    B and C once each a pass for the SSD, in a decode step x and dt for
    the SSD cache's layout, and no more activation bytes than those
    (``_ssm_account``); every gather is a redistribution's."""
    got = runs[case]["sharded"]
    assert int(got["gathers:ssm"]) > 0
    assert int(got["ssm:bad"]) == 0
    assert int(got["ssm:unknown"]) == 0
    assert 0 < int(got["ssm:bytes"]) <= int(got["ssm:allow"])


@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_the_ssd_on_local_shards_matches_unsharded_and_jax(runs, case):
    """Fault G: ``ssd_chunked`` on DTensors runs on each rank's local
    shards, its heads split over model where they divide it (4 heads) and
    whole on each rank where not (3), with a tail short of a chunk and
    without: y, the final state and the grads of x, dt, a_log, B, C and
    d_skip in fp32 against the unsharded port and JAX's ``jax.grad``, at
    ``TOL``.  y and the state keep the batch split over data and the heads'
    layout."""
    H, L = SSD_CASES[case]
    _assert_close(runs, case, ["y", "state", *(f"grad.{k}"
                                              for k in SSD_ARGS)])
    got = runs[case]["sharded"]
    heads = H // 2 if H % 2 == 0 else H
    assert list(got["shape:y"]) == [B // 2, L, heads, SSD_P]
    assert list(got["shape:state"]) == [B // 2, heads, SSD_N, SSD_P]


def test_a_partial_output_takes_the_replicated_cotangent(runs):
    """Fault J: an output of ``on_local_shards`` laid out as a ``Partial``
    sum over model (a @ b on each rank's piece of the contraction) takes
    its grad replicated: on every rank the body's product receives its
    rows of the whole cotangent g.  The product, reduced, and the grads of
    a and b match the unsharded port and ``jax.grad`` at ``TOL``."""
    assert bool(runs[PARTIAL_CASE]["sharded"]["cotangent_is_g"])
    _assert_close(runs, PARTIAL_CASE, ["y", "grad.a", "grad.b"])
