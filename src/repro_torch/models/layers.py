"""Shared model layers of the port: RMSNorm, RoPE, GQA attention (prefill
and decode), SwiGLU and sort-based MoE dispatch.  Twin of
``repro.models.layers``.

Two of them run the port's kernels through ``kernels.ops``, which launches
the CUDA kernel for a tensor on the card and takes its plain PyTorch version
on the CPU:
  * ``rmsnorm`` runs the RMSNorm kernel, which computes exactly the JAX
    layer's function (fp32 inside, cast back to x's dtype);
  * ``attention`` runs the flash-attention kernel, which computes the JAX
    layer's function at any length and skips masked tiles.  Its plain
    version and its backward take the JAX layer's three paths: dense up to
    ``dense_max_seq`` (or where ``chunk`` does not divide S), q-chunked
    above it, and block-skipping under ``block_skip``, so that above
    ``dense_max_seq`` no (S, S) score tensor is made, on the CPU, on meta
    or in the card's backward.
``decode_attention``, ``swiglu`` and ``moe_ffn`` stay plain PyTorch, as the
JAX package leaves them to XLA outside any Pallas kernel.  ``remat`` is the
twin of the reference's ``jax.checkpoint`` around a layer: the models'
training forwards run each layer under it.

Under a mesh (DTensors under ``use_sharding``) the norm, the attention and
the decode attention run their bodies on each rank's local shards
(``parallel.sharding.on_local_shards``): the kernels on the card, the plain
versions off it.  Attention keeps q's heads sharded as ``act_heads``
resolves, as the reference's layer does under GSPMD; the decode attention
reads each rank's shard of the cache where it lies; a norm whose row the
mesh splits all-reduces the pieces' sums of squares, the rmsnorm kernel's
two split entry points on either side (``_split_rmsnorm``).
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import torch
# checkpoint's first call imports torch._dynamo (``torch._disable_dynamo``),
# and that import leaves frames in a reference cycle (``torch.fx.wrap``
# keeps its own): the cycle holds the caller's stack, a train step's frames
# and their tensors, until a full collection.  Imported here, it holds none.
import torch._dynamo  # noqa: F401
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils._pytree import tree_leaves
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..kernels import ops
from ..kernels._build import wide
from ..parallel.sharding import (all_reduce_over, constrain, current_ctx,
                                 grad_placed, is_shard, is_sharded,
                                 logical_spec, on_local_shards, placements,
                                 reentered, replicate_as, rows_of,
                                 shard_bounds, summed_to_rows, widened)

NEG_INF = -1e30
# the products with no batch dims: ``x @ w`` with a 2-D ``w`` lowers to one
# of these.  An einsum lowers to ``bmm`` whether it has batch dims or not:
# the one without (the MoE router's) runs under ``_no_batch_dims``
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_BMM = torch.ops.aten.bmm.default
_UNBATCHED = contextvars.ContextVar("unbatched_einsum", default=False)


# ---------------------------------------------------------------------------
# recomputation
# ---------------------------------------------------------------------------
def _save_dots(ctx, op, *args, **kwargs):
    """``policy="dots"``: the twin of JAX's
    ``checkpoint_dots_with_no_batch_dims``.  A product without batch dims
    keeps its output; every other op, ``bmm`` and the kernels' buffers
    included, runs again in the backward.  The norm and flash kernels
    launch through ctypes inside their ``autograd.Function``s, so this
    policy never sees them as products: they are recomputed, as the
    reference recomputes their jnp bodies."""
    if op in _DOTS or (op is _BMM and _UNBATCHED.get()):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


@contextlib.contextmanager
def _no_batch_dims():
    """Marks the einsums run inside as products without batch dims, which
    ``"dots"`` keeps, though each lowers to a ``bmm`` over a batch of 1."""
    token = _UNBATCHED.set(True)
    try:
        yield
    finally:
        _UNBATCHED.reset(token)


@contextlib.contextmanager
def _recompute_in(ctx, inner):
    with reentered(ctx), inner:
        yield


def _contexts(policy: str):
    """``checkpoint``'s ``context_fn`` for ``policy``: the selective
    contexts of ``"dots"`` (none for any other policy), the recompute's
    inside the sharding context that the forward ran under."""
    ctx = current_ctx()

    def context_fn():
        first, again = (create_selective_checkpoint_contexts(_save_dots)
                        if policy == "dots" else
                        (contextlib.nullcontext(), contextlib.nullcontext()))
        return first, _recompute_in(ctx, again)

    return context_fn


def remat(fn, policy: str = "nothing"):
    """``fn`` recomputed in the backward, the twin of ``jax.checkpoint(fn,
    policy=...)``: ``"dots"`` keeps ``fn``'s inputs and the outputs of its
    products without batch dims (``_save_dots``), any other policy its
    inputs alone, as the reference maps every policy but ``"dots"`` to
    ``nothing_saveable`` (transformer.py:27-30).
    Where autograd does not record (grad mode off, as under the serving
    steps' ``inference_mode``, or no input that requires grad) the
    returned function calls ``fn`` as it is, at no host cost.  No forward
    of the port draws random numbers, so the RNG state is not kept.  The
    recompute stops at the last tensor the backward needs (torch's early
    stop): a layer's last product, whose output no backward reads, runs
    once, as XLA drops it from the reference's recompute as dead code.
    The recompute runs under the sharding context of the forward
    (``parallel.sharding.reentered``): on CUDA tensors the backward runs
    on autograd's device thread, which does not see the caller's.  Pass
    every tensor ``fn`` reads as an argument: only those decide whether
    autograd records."""
    def run(*args):
        if not (torch.is_grad_enabled()
                and any(isinstance(t, torch.Tensor) and t.requires_grad
                        for t in tree_leaves(args))):
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False,
                          context_fn=_contexts(policy))

    return run


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last dim of ``x`` by ``w`` (fp32 masters with bf16
    activations, as the models pass them).  All rows go to one kernel call:
    ``block_rows=rows`` keeps the Pallas path's tiling check satisfiable at a
    decode step's 1-4 rows (the JAX models never called the Pallas kernel,
    so there is no reference tiling).  Under a mesh each rank normalises
    the rows of its own shard (``on_local_shards``), and the rows keep
    their sharding.  Where the normalised dim is sharded too (a branch
    output over its heads, mamba2's gated norm over ``ff``), each rank
    takes its own columns and ``w``'s, and the row is never gathered:
    ``_split_rmsnorm``."""
    if is_sharded(x):
        from torch.distributed.tensor import Replicate

        last = x.ndim - 1
        pls = [p if is_shard(p) else Replicate() for p in x.placements]
        row_dims = [m for m, p in enumerate(pls) if is_shard(p)
                    and p.dim == last]
        if row_dims:
            return _split_rmsnorm(x, w, eps, pls, row_dims)
        rep = [Replicate()] * x.device_mesh.ndim
        return on_local_shards(lambda xl, wl: _rmsnorm_rows(xl, wl, eps),
                               [(x, pls), (replicate_as(w, x), rep)],
                               [pls])[0]
    return _rmsnorm_rows(x, w, eps)


def _rmsnorm_rows(x: torch.Tensor, w: torch.Tensor, eps: float
                  ) -> torch.Tensor:
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    out = ops.rmsnorm(x2, w, eps=eps, block_rows=max(1, x2.shape[0]))
    return out.reshape(x.shape)


def _split_rmsnorm(x, w, eps, pls, row_dims):
    """The norm of DTensor rows whose last dim the mesh dims ``row_dims``
    split, as GSPMD runs the reference's jnp norm on them: on each rank the
    sum of squares of its own columns (``ops.rmsnorm_sumsq``), an
    all-reduce of those (rows,) fp32 sums over ``row_dims``, and the scale
    of its own columns by its own piece of ``w`` (``ops.rmsnorm_scale``);
    the backward takes one more (rows,) all-reduce (``_SplitRMSNorm``).
    ``w`` is laid out as x's last dim, a chunk of each rank's own."""
    from torch.distributed.tensor import Replicate, Shard

    mesh, d_full = x.device_mesh, x.shape[-1]
    # w's one dim split as x's last: the same placement type on each mesh
    # dim of row_dims (a _StridedShard keeps its split factor)
    wpls = [Replicate() if m not in row_dims else Shard(0)
            if type(p) is Shard else type(p)(0, split_factor=p.split_factor)
            for m, p in enumerate(pls)]

    def all_reduce(t):
        return all_reduce_over(t, "sum", mesh, row_dims)

    def body(xl, wl):
        x2 = xl.reshape(-1, xl.shape[-1]).contiguous()
        if torch.is_grad_enabled() and (x2.requires_grad or wl.requires_grad):
            out = _SplitRMSNorm.apply(x2, wl, eps, d_full, all_reduce)
        else:
            out = _split_rows(x2, wl, eps, d_full, all_reduce)[0]
        return out.reshape(xl.shape)

    return on_local_shards(body, [(x, pls), (replicate_as(w, x), wpls)],
                           [pls])[0]


def _split_rows(x, w, eps, d_full, all_reduce):
    """(out, totals) of rows ``x`` (rows, d) whose columns are a piece of
    rows of ``d_full``: the pieces' sums of squares all-reduced."""
    total = all_reduce(ops.rmsnorm_sumsq(x))
    return ops.rmsnorm_scale(x, w, total, d_full=d_full, eps=eps), total


class _SplitRMSNorm(torch.autograd.Function):
    """``_split_rows`` forward; backward in fp32 by the whole-row norm's
    closed form (``kernels.rmsnorm.RMSNormFunction``), its row sums over
    the pieces: r = rsqrt(total / d_full + eps) from the forward's totals,
    the all-reduce of each piece's sum(x w g), and
        dx = r (w g) - x r^3 sum(x w g) / d_full,
        dw = sum over rows of g x r,
    dw for the piece's own columns (a partial sum over the rows, which
    ``on_local_shards`` reduces where the rows are sharded)."""

    @staticmethod
    def forward(ctx, x, w, eps, d_full, all_reduce):
        out, total = _split_rows(x, w, eps, d_full, all_reduce)
        ctx.save_for_backward(x, w, total)
        ctx.eps, ctx.d_full, ctx.all_reduce = eps, d_full, all_reduce
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, total = ctx.saved_tensors
        xf, wf, gf = wide(x), wide(w), wide(g)
        r = torch.rsqrt(wide(total) / ctx.d_full + ctx.eps)[:, None]
        wg = wf * gf
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dot = ctx.all_reduce((xf * wg).sum(dim=-1))[:, None]
            dx = (r * wg - xf * r ** 3 * dot / ctx.d_full).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = (gf * xf * r).sum(dim=0).to(w.dtype)
        return dx, dw, None, None, None


def embed(table: torch.Tensor, tokens: torch.Tensor,
          dtype: torch.dtype | None = None) -> torch.Tensor:
    """``table[tokens]``, cast to ``dtype`` where given.  Under a mesh a
    vocab-parallel lookup on each rank's local shards
    (``_sharded_embed``), laid out as the reference constrains it,
    ("batch", ..., "act_embed"), before it leaves: a model may read its
    embeddings twice (hymba's norm and residual)."""
    if not is_sharded(table):
        out = table[tokens]
        return out if dtype is None else out.to(dtype)
    return _sharded_embed(table, replicate_as(tokens, table),
                          dtype or table.dtype)


def _vocab_index(ids: torch.Tensor, v0: int, rows: int) -> tuple:
    """(each id's row of the rank's vocab rows [v0, v0 + rows), 0 where it
    falls outside them; whether it falls inside)."""
    rel = ids.long() - v0
    hit = (rel >= 0) & (rel < rows)
    return torch.where(hit, rel, 0), hit


class _Lookup(torch.autograd.Function):
    """``_sharded_embed``'s lookup on DTensors.  Forward (``plan``: the
    mesh, the placements the table, the ids and the rows take, the mesh
    dims whose rows go back, the rank's first vocab row, the dtype): the
    table and the ids taken to their placements, each rank's rows of its
    local table read for the ids among them, zeros for the rest, cast to
    the dtype, the rows put back (``_rows_back``); a DTensor, a
    ``Partial`` sum over the mesh dims that split the vocab.  It saves the
    rank's ids alone.  Backward: the cotangent (whole where the rows are a
    partial sum), its rows taken back to the ids', cast to the table's
    dtype and accumulated into zeros of the rank's rows: the table's
    grad, laid out as the table was read, a ``Partial`` sum over the mesh
    dims that split the ids and not the table, handed on unreduced, for
    the one reduction where the caller places it (``models.loss_and_grads``),
    a tied head's grad summed in first."""

    @staticmethod
    def forward(ctx, table, ids, plan):
        from torch.distributed.tensor import DTensor

        mesh, tp, ip, yp, back, v0, dtype = plan
        tl = table.redistribute(mesh, tp).to_local()
        il = ids.redistribute(mesh, ip).to_local()
        rows = tl.shape[0]
        idx, hit = _vocab_index(il, v0, rows)
        y = tl.index_select(0, idx.flatten()).view(*il.shape, -1)
        y = y.masked_fill_(~hit[..., None], 0).to(dtype)
        del tl
        for m in back:
            y = _rows_back(y, mesh, m)
        ctx.save_for_backward(il)
        ctx.plan = plan
        ctx.table = (table.shape, table.stride(), rows, table.dtype)
        return DTensor.from_local(y, mesh, yp, run_check=False)

    @staticmethod
    def backward(ctx, dy):
        from torch.distributed.tensor import DTensor, Partial, Replicate

        il, = ctx.saved_tensors
        mesh, tp, ip, yp, back, v0, _ = ctx.plan
        shape, stride, rows, dtype = ctx.table
        dy = dy.redistribute(mesh, [Replicate() if p.is_partial() else p
                                    for p in yp]).to_local()
        for m in reversed(back):
            dy = _rows_back(dy, mesh, m, inverse=True)
        idx, hit = _vocab_index(il, v0, rows)
        dy = torch.where(hit[..., None], dy, 0).to(dtype)
        # the indexing's own backward op, so that one rank's grad is the
        # unsharded lookup's bit for bit
        dt = dy.new_zeros((rows, dy.shape[-1])).index_put_(
            (idx,), dy, accumulate=True)
        pls = [p if is_shard(p) else Partial() if is_shard(q) else
               Replicate() for p, q in zip(tp, ip)]
        return DTensor.from_local(dt, mesh, pls, run_check=False,
                                  shape=shape, stride=stride), None, None


def _sharded_embed(table, ids, dtype) -> torch.Tensor:
    """``embed`` on DTensors, a vocab-parallel lookup in one closed form
    (``_Lookup``).  Each rank looks up the ids that fall in its vocab rows
    of its local table and writes zeros for the rest: a ``Partial`` sum
    over the mesh dims that split the vocab, reduced once, in ``dtype``
    (exact: one rank holds each row), to the reference's (batch, ...,
    act_embed) placements (``summed_to_rows``, then the rows' layout).  A mesh dim that splits the
    table's M (FSDP's ``embed``) takes ``_fsdp_layout``'s choice by bytes:
    ``"gather_w"`` gathers the table there (training, prefill),
    ``"gather_h"`` gathers the ids (4 B a token) and each rank makes its
    slice of M for every row, the rows put back by one all-to-all after the
    lookup (M gathered after the reduction, of the rank's slice, where the
    rows are whole: a batch of one): a decode step, which never gathers
    the table.  The
    table's grad is reduced once, where ``models.loss_and_grads`` places
    it (none where the ids were gathered).  The ids take no DTensor op:
    2.11's rules refuse a dim split over two mesh axes, as the batch is
    over (pod, data) on 2x16x16."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh, (V, M) = table.device_mesh, table.shape
    shape = (*ids.shape, M)
    target = placements(logical_spec(
        shape, ("batch", *(None,) * (ids.dim() - 1), "act_embed")), mesh)
    rows = [p if is_shard(p) and p.dim == 0 else Replicate() for p in target]
    v0 = shard_bounds(table.shape, mesh, table.placements, 0)[0]
    y_bytes = _local_bytes(shape, mesh, rows, torch.finfo(dtype).bits // 8)
    ip, tp, yp, back = [], [], [], []
    for i, (p, r) in enumerate(zip(table.placements, rows)):
        if is_shard(p) and p.dim == 0:      # the vocab: a partial sum
            cols = (Replicate(), p, Partial())
        elif is_shard(p) and p.dim == 1 and _fsdp_layout(
                mesh.size(i), _nbytes(ids), _nbytes(table), y_bytes,
                is_shard(r), False) == "gather_h":
            # each rank's slice of M; its rows put back, or M gathered
            cols = (Replicate(), p, r if is_shard(r) else Shard(ids.dim()))
            if is_shard(r):
                back.append(i)
        else:
            cols = (r, Replicate(), r)
        for out, pl in zip((ip, tp, yp), cols):
            out.append(pl)
    plan = (mesh, tuple(tp), tuple(ip), tuple(yp), tuple(back), v0, dtype)
    return summed_to_rows(_Lookup.apply(table, ids, plan)).redistribute(
        mesh, target)


def _rows_back(y: torch.Tensor, mesh, m: int, inverse: bool = False
               ) -> torch.Tensor:
    """A rank's slice of the last dim of every row of ``y`` (the rows
    gathered over mesh dim ``m``, which splits them) taken back to its
    own rows and the whole last dim, by one all-to-all over ``m``; with
    ``inverse`` the way back."""
    from torch.distributed import _functional_collectives as funcol

    n = mesh.size(m)
    if inverse:     # (B / n, ..., M) -> (n, B / n, ..., M / n)
        y = y.unflatten(-1, (n, -1)).movedim(-2, 0).flatten(0, 1)
    got = funcol.wait_tensor(funcol.all_to_all_single_autograd(
        y.contiguous(), None, None, (mesh, m)))
    if inverse:     # the rows of rank j came from rank j
        return got
    # what came from rank j is its slice j of M for this rank's rows
    return got.unflatten(0, (n, -1)).movedim(0, -2).flatten(-2)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(hd: int, theta: float, fraction: float = 1.0,
               device=None) -> torch.Tensor:
    """Inverse frequencies (fp32) for the rotated sub-dimension."""
    rot = int(hd * fraction)
    rot -= rot % 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               fraction: float = 1.0) -> torch.Tensor:
    """x: (B, S, H, D); positions: (S,) or (B, S).  Rotates interleaved lane
    pairs (0::2, 1::2) with fp32 angles, as the JAX layer does (not the
    split-half layout).  ``fraction < 1`` rotates only the leading sub-dim
    (ChatGLM-style partial RoPE)."""
    b, s, h, d = x.shape
    inv = replicate_as(rope_freqs(d, theta, fraction, device=x.device), x)
    rot = inv.shape[0] * 2
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[:, :, None].float() * inv[None, None, :]
    cos = torch.cos(ang)[:, :, None, :]  # (B, S, 1, rot/2)
    sin = torch.sin(ang)[:, :, None, :]
    xr = x[..., :rot].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(b, s, h, rot).to(x.dtype)
    return torch.cat([out, x[..., rot:]], dim=-1) if rot < d else out


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def _heads_names(lead: tuple) -> tuple:
    """Logical names of (B, [S,] heads): the batch, a sequence, the heads."""
    return ("batch",) + ("seq",) * (len(lead) - 1) + ("act_heads",)


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """x (B, [S,] heads * D) -> (B, [S,] heads, D).  Under a mesh the last
    dim is first sharded as the heads alone can be ("act_heads"): DTensor
    cannot split a shard across a head boundary (8 kv heads on 16 ranks),
    where GSPMD reshards by itself."""
    lead = tuple(x.shape[:-1])
    x = constrain(x, *_heads_names(lead), shape=lead + (heads,))
    return x.reshape(*lead, heads, -1)


def merge_heads(o: torch.Tensor) -> torch.Tensor:
    """o (B, [S,] H, D) -> (B, [S,] H * D), the inverse of
    ``split_heads``.  Under a mesh the merged dim is constrained, grad
    included, to a sharding the heads alone can take, so that the split
    keeps to shard edges (25 heads on 16 ranks) in the backward too."""
    lead, (h, d) = tuple(o.shape[:-2]), o.shape[-2:]
    return constrain(o.reshape(*lead, h * d), *_heads_names(lead),
                     shape=lead + (h,))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              dense_max_seq: int = 1024, chunk: int = 1024,
              block_skip: bool = False) -> torch.Tensor:
    """GQA attention over a whole sequence, causal and within ``window``
    positions (a key at p is seen from rows p..p+window-1) where given.
    q: (B, Hq, S, D); k, v: (B, Hkv, S, D).  Positions are 0..S-1, as in
    every model path, so the kernel's top-left mask on indices is the JAX
    layer's mask on positions; every row sees at least itself, so the JAX
    bias fill of -1e30 and the kernel agree.  ``bq = bk = S`` satisfy the
    TPU kernel's tiling check at any length; the CUDA kernel tiles by
    itself.  The JAX layer's dispatch (layers.py:156-168): dense where
    ``S <= dense_max_seq`` or ``S % chunk``, else ``chunk`` q rows at a
    time, over the causal and window slice of the keys under
    ``block_skip`` (``ops.flash_attention``'s ``chunk``).  Under a mesh
    see ``_sharded_attention``."""
    s = q.shape[2]
    kw = dict(causal=causal, window=window)
    if s > dense_max_seq and s % chunk == 0:
        kw.update(chunk=chunk, block_skip=block_skip)
    if is_sharded(q):
        return _sharded_attention(q, k, v, **kw)
    return ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               bq=s, bk=s, **kw)


def _sharded_attention(q, k, v, **kw):
    """``attention`` on each rank's local shards, as the reference's layer
    runs it under GSPMD (transformer.py:101-102): q over the batch and its
    heads as ``act_heads`` resolves, k and v over the same mesh dims where
    their heads divide them and replicated elsewhere (8 kv heads on 16
    ranks; 25 or 36 heads replicate q too).  A rank then takes the kv
    heads its own q heads use: one slice where its q heads fall in one kv
    head or cover whole ones, one kv head a q head (group 1) otherwise.
    The sequence is never split here, so a q chunk (``kw``'s ``chunk``)
    is one of the local rows.  Where a graph is recorded, k and v enter
    widened to fp32 (``widened``): the pick's backward sums a kv head's
    grads over its q heads in fp32, the ranks that share a kv head sum
    theirs in fp32, and each grad is rounded to bf16 once, after both."""
    from torch.distributed.tensor import Replicate

    mesh, (_, hq, s, _), hkv = q.device_mesh, q.shape, k.shape[1]
    qp = placements(logical_spec(q.shape, ("batch", "act_heads", None, None)),
                    mesh)
    head_ways = math.prod(mesh.size(m) for m, p in enumerate(qp)
                          if is_shard(p) and p.dim == 1)
    kp, pick = qp, None
    if hkv % head_ways:
        kp = [Replicate() if is_shard(p) and p.dim == 1 else p for p in qp]
        h0, h1 = shard_bounds(q.shape, mesh, qp, 1)
        g = hq // hkv
        if (h1 - h0) % g == 0 or g % (h1 - h0) == 0:
            pick = slice(h0 // g, (h1 - 1) // g + 1)
        else:
            pick = [h // g for h in range(h0, h1)]
    if torch.is_grad_enabled() and (k.requires_grad or v.requires_grad):
        k, v = widened(k, kp), widened(v, kp)

    def body(ql, kl, vl):
        if isinstance(pick, list):
            pick_ = torch.tensor(pick, device=kl.device)
            kl, vl = kl[:, pick_], vl[:, pick_]
        elif pick is not None:
            kl, vl = kl[:, pick], vl[:, pick]
        return ops.flash_attention(ql.contiguous(), kl.contiguous(),
                                   vl.contiguous(), bq=s, bk=s, **kw)

    return on_local_shards(body, [(q, qp), (k, kp), (v, kp)], [qp])[0]


def _decode_local(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, valid_mask: torch.Tensor,
                  all_reduce=None) -> torch.Tensor:
    """``decode_attention``'s arithmetic.  ``all_reduce(t, op)`` combines a
    value across the ranks that split the slots: the softmax is then taken
    as a log-sum-exp combine, the local max, its all-reduce, the local
    exponentials' sum and P.V, and their all-reduces."""
    b, hq, _, d = q.shape
    hkv = k_cache.shape[1]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d)
    scores = torch.einsum("bhgd,bhkd->bhgk", qg.float(),
                          k_cache.float()) / math.sqrt(d)
    if valid_mask.dim() == 1:
        valid_mask = valid_mask[None, :]
    scores = torch.where(valid_mask[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    if all_reduce is None:
        p = torch.softmax(scores, dim=-1)
        o = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float())
    else:
        m = all_reduce(scores.amax(dim=-1, keepdim=True), "max")
        p = torch.exp(scores - m)
        total = all_reduce(p.sum(dim=-1, keepdim=True), "sum")
        o = all_reduce(torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float()),
                       "sum") / total
    return o.reshape(b, hq, 1, d).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *,
                     valid_mask: torch.Tensor) -> torch.Tensor:
    """Single-position attention over a cache.  q: (B, Hq, 1, D); k/v_cache:
    (B, Hkv, S, D); ``valid_mask`` (B, S) or (S,) says which entries are
    visible.  Under a mesh each rank attends over its own shard of the
    cache, which stays where it is: q takes the cache's batch and head
    layout, and where the slots are sharded (``kv_seq``) the softmax
    combines across the slot shards (``_decode_local``), as GSPMD runs a
    softmax over a sharded dim."""
    if not is_sharded(k_cache):
        return _decode_local(q, k_cache, v_cache, valid_mask)
    from torch.distributed.tensor import Replicate, Shard

    mesh, kpl = k_cache.device_mesh, tuple(k_cache.placements)
    dims = [p.dim if is_shard(p) else None for p in kpl]
    if any(d == 2 and type(p) is not Shard for p, d in zip(kpl, dims)):
        raise NotImplementedError("cache slots split by a strided shard")
    slot_dims = [m for m, d in enumerate(dims) if d == 2]
    qp = [p if d in (0, 1) else Replicate() for p, d in zip(kpl, dims)]
    mask = replicate_as(valid_mask, k_cache)
    last = mask.dim() - 1         # the slots; a (B, S) mask has the batch
    mp = [Shard(last) if d == 2 else p if d == 0 and last else Replicate()
          for p, d in zip(kpl, dims)]

    def all_reduce(t, op):
        return all_reduce_over(t, op, mesh, slot_dims)

    def body(ql, kl, vl, ml):
        return _decode_local(ql, kl, vl, ml,
                             all_reduce if slot_dims else None)

    return on_local_shards(body, [(q, qp), (k_cache, kpl), (v_cache, kpl),
                                  (mask, mp)], [qp])[0]


def out_proj(o: torch.Tensor, w: torch.Tensor, like: torch.Tensor
             ) -> torch.Tensor:
    """``o @ w``, a decode step's output projection of its heads (or the
    SSM's inner dim) o (B, [1,] K) by w (K, M), laid out as ``like`` (the
    residual it is added to).  Under a mesh one ``on_local_shards`` body:
    each rank multiplies its slice of K by its slice of w, a ``Partial``
    (B, [1,] M) over the mesh dims that split K, reduced once to like's
    placements.  A mesh dim that splits w's M (FSDP's ``embed``) takes
    ``_fsdp_layout``'s choice by bytes: ``"gather_w"`` gathers w there,
    ``"gather_h"`` gathers o's rows and each rank makes its slice of M for
    every row, the rows put back by one all-to-all (``_rows_back``; M
    gathered after the reduction where the rows are whole).  The partial
    sum is reduced first (``summed_to_rows``), then laid out as like."""
    if not is_sharded(o):
        return o @ w
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh, last, size = o.device_mesh, o.ndim - 1, o.element_size()
    rows = rows_of(o)
    # o's rows, K split as w's (a local slice where o is whole there)
    kp = [_on_dim(p, last) if is_shard(p) and p.dim == 0 else r
          for p, r in zip(w.placements, rows)]
    if tuple(o.placements) != tuple(kp):
        o = o.redistribute(mesh, kp)
    y_bytes = _local_bytes((*o.shape[:-1], w.shape[1]), mesh, rows, size)
    op, wp, yp, back = [], [], [], []
    for i, (p, r) in enumerate(zip(w.placements, rows)):
        if is_shard(p) and p.dim == 0:      # K: a partial sum
            cols = (kp[i], p, Partial())
        elif is_shard(p) and p.dim == 1 and _fsdp_layout(
                mesh.size(i), _nbytes(o), _nbytes(w), y_bytes, is_shard(r),
                False) == "gather_h":
            cols = (Replicate(), p, r if is_shard(r) else Shard(last))
            if is_shard(r):
                back.append(i)
        else:
            cols = (r, Replicate(), r)
        for out, pl in zip((op, wp, yp), cols):
            out.append(pl)

    def body(ol, wl):
        y = ol @ wl
        for i in back:
            y = _rows_back(y, mesh, i)
        return y

    y, = on_local_shards(body, [(o, op), (w, wp)], [yp])
    return summed_to_rows(y).redistribute(
        mesh, [Replicate() if p.is_partial() else p for p in like.placements])


def decode_ffn(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
               w2: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``swiglu(x, w1, w3, w2)`` of a decode step, x (B, [1,] M), laid out
    as ``like`` (the residual it is added to).  Under a mesh in one closed
    form: the two up-projections in one ``on_local_shards`` body, the
    hidden silu(x @ w1) * (x @ w3) on the rows' layout, and the
    down-projection by ``out_proj``.  A mesh dim that splits w1's and w3's
    M (FSDP's ``embed``) takes ``_fsdp_up_layout``'s choice by bytes:
    ``"split_m"`` takes each rank's slice of M of every row (x's rows
    exchanged for it by one all-to-all, ``_rows_back``'s way back; a local
    slice where the rows are whole) and reduces each product's partial sum
    once, to the rows' layout (``summed_to_rows``); ``"gather_w"`` gathers
    the two weights.  Without a mesh ``swiglu``."""
    if not is_sharded(x):
        return swiglu(x, w1, w3, w2, shard_acts=False)
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh, last = x.device_mesh, x.ndim - 1
    rows = rows_of(x)
    hp = [_on_dim(p, last) if is_shard(p) and p.dim == 1 else r
          for p, r in zip(w1.placements, rows)]
    h_bytes = _local_bytes((*x.shape[:-1], w1.shape[1]), mesh, hp,
                           x.element_size())
    xp, wp, op, back = [], [], [], []
    for i, (p, r) in enumerate(zip(w1.placements, rows)):
        if is_shard(p) and p.dim == 1:      # F: each rank's columns
            cols = (r, p, hp[i])
        elif is_shard(p) and p.dim == 0 and _fsdp_up_layout(
                mesh.size(i), _nbytes(x), 0, _nbytes(w1), h_bytes,
                is_shard(r)) == "split_m":
            # M: a partial sum; the rows exchanged for M, or M sliced
            cols = (r if is_shard(r) else Shard(last), p, Partial())
            if is_shard(r):
                back.append(i)
        else:
            cols = (r, Replicate(), r)
        for out, pl in zip((xp, wp, op), cols):
            out.append(pl)

    def body(xl, w1l, w3l):
        for i in back:
            xl = _rows_back(xl, mesh, i, inverse=True)
        return xl @ w1l, xl @ w3l

    a1, a3 = on_local_shards(body, [(x, xp), (w1, wp), (w3, wp)], [op, op])
    h = F.silu(summed_to_rows(a1)) * summed_to_rows(a3)
    return out_proj(h, w2, like)


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------
def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor, shard_acts: bool = True) -> torch.Tensor:
    """x: (B, S, M); w1/w3: (M, F); w2: (F, M).  ``shard_acts``: the
    hidden (B, S, F) constrained as the reference's (layers.py:205)."""
    h = F.silu(x @ w1) * (x @ w3)
    if shard_acts:
        h = constrain(h, "batch", "seq", "act_ff")
    return h @ w2


# ---------------------------------------------------------------------------
# MoE: sort-based dispatch with capacity (token dropping)
# ---------------------------------------------------------------------------
def _span(name: str):
    """A profiler span named ``name``, opened only while a profiler
    records: without one a span still costs the host a dispatcher call on
    entry and on exit, on decode steps that the host bounds."""
    if torch._C._autograd._profiler_enabled():
        return record_function(name)
    return contextlib.nullcontext()


def _by_rows(fn, *ts: torch.Tensor, n_out: int) -> tuple:
    """``fn(*ts)``, a tuple of ``n_out`` tensors whose first dim is the
    batch, as the first of ``ts``; on DTensors under a mesh on each rank's
    rows (``on_local_shards``), the inputs and outputs split over the batch
    as ``ts[0]`` is and replicated on every other mesh dim.  For the MoE's
    routing, a row at a time: DTensor 2.11 has no placement-keeping rule
    for an in-place ``scatter_`` of a tensor split over the batch, and the
    backward of ``topk`` scatters a DTensor into a plain tensor."""
    if not is_sharded(ts[0]):
        return fn(*ts)
    pls = rows_of(ts[0])
    return on_local_shards(fn, [(t, pls) for t in ts], [pls] * n_out)


def _top_k(gates: torch.Tensor, k: int) -> tuple:
    """The k largest gates of each token, renormalised by their sum
    (floored at 1e-9), and their expert ids.  On a mesh the sum runs on
    each rank's rows too, so that the grad of the weights, a partial sum
    over the ranks that hold the experts or F, is reduced once where
    ``_by_rows`` hands it back, not wherever a release of DTensor places
    the division's backward."""
    top_w, top_ids = torch.topk(gates, k, dim=-1)
    return top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9), \
        top_ids


def _expert_slots(top_ids: torch.Tensor, e: int, c: int) -> tuple:
    """Each assignment's destination among the E * C slots (a dropped
    one's: a spare slot of its own past them) and whether it was kept, (B,
    S * k) each, from the top-k expert ids (B, S, k), token-major."""
    b, s, k = top_ids.shape
    dev = top_ids.device
    flat_ids = top_ids.reshape(b, s * k)
    sid, order = torch.sort(flat_ids, dim=-1, stable=True)
    # rank within expert: position - first position of this expert id
    experts = torch.arange(e, device=dev).expand(b, e).contiguous()
    first = torch.searchsorted(sid, experts)
    flat = torch.arange(s * k, device=dev)
    rank = flat - first.gather(1, sid)
    slot = torch.empty_like(rank).scatter_(1, order, rank)  # flat order
    kept = slot < c
    flat = flat.expand(b, s * k)
    return torch.where(kept, flat_ids * c + slot, e * c + flat), kept


def _slot_tokens(dest: torch.Tensor, s: int, k: int, e: int, c: int
                 ) -> tuple:
    """The token of each of the E * C slots (B, E * C) from the
    assignments' destinations; an empty slot reads row s, zeros."""
    b = dest.shape[0]
    flat = torch.arange(s * k, device=dest.device).expand(b, s * k)
    tok = torch.full((b, e * c + s * k), s, dtype=torch.long,
                     device=dest.device)
    return tok.scatter_(1, dest, flat // k)[:, :e * c],


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, we1: torch.Tensor,
            we3: torch.Tensor, we2: torch.Tensor, *, n_experts: int,
            top_k: int, capacity: int, shard_acts: bool = True
            ) -> torch.Tensor:
    """x: (B, S, M) -> (B, S, M); router_w (M, E), we1/we3 (E, M, F), we2
    (E, F, M).  The function of the JAX layer (layers.py:213-286), per
    batch row:
      1. fp32 router logits, softmax, top-k; the k weights renormalised by
         their sum (floored at 1e-9);
      2. the S*k assignments (token-major, flat index token * k + j)
         stably sorted by expert id; slot = rank within the expert;
      3. slots >= ``capacity`` dropped: they contribute nothing;
      4. tokens gathered to (B, E, C, M), the expert SwiGLU with the weights
         cast to x's dtype, each assignment's output times its bf16 weight,
         summed over its token's k assignments.

    Every shape is static and no index list is built on the host: a dropped
    assignment is scattered to a spare slot of its own past the E * C real
    ones, which are sliced off, where JAX scatters to the out-of-range
    expert ``E`` with ``mode="drop"``.  A slot that no assignment fills
    reads an appended zero row of x.  While a profiler records, each stage
    runs in a span (``moe.router``, ``moe.sort``, ``moe.dispatch``,
    ``moe.experts``, ``moe.combine``), which ``trace_main_path --moe-only``
    reads.

    ``shard_acts`` constrains the gathered tokens and the experts' hidden
    as the reference does (layers.py:262, 272).  Under a mesh the dispatch
    and the expert up-projections run on each rank's local shards and hand
    on the hidden placed as that constraint says
    (``_local_dispatch_and_up``); x's grad, the router's and the
    dispatch's, is reduced once (``grad_placed``); the expert
    down-projection and the combine run on local shards too and the token
    output is reduced once (``_local_down_and_combine``), where the
    reference leaves the products' placements to GSPMD.

    Ties: ``torch.topk`` does not promise ``lax.top_k``'s lower-index-first
    order on equal gates, so on exact ties the two may pick other experts;
    random fp32 router logits have none.

    Combine: JAX scatter-adds the (E * C) weighted outputs into (S, M) in
    bf16, rounding after each add, in expert order.  Here each token
    gathers its k weighted outputs through the map (token, j) -> (expert,
    slot) and sums them in fp32 with one rounding to bf16.  The sum has no
    atomics, so two runs on the card give the same bits; against JAX it
    differs by at most (k - 1) / 2 bf16 ulps of the output, under the bf16
    tolerance (rtol 3e-2) the tests hold it to.
    """
    b, s, m = x.shape
    e, c, k = n_experts, capacity, top_k
    if is_sharded(x):
        # the router's and the dispatch's grads of x, each a partial sum
        # over the mesh dims that split E or F, summed and reduced once
        x = grad_placed(x)
    with _span("moe.router"):
        with _no_batch_dims():
            logits = torch.einsum("bsm,me->bse", x.float(),
                                  router_w.float())
        gates = torch.softmax(logits, dim=-1)                    # (B,S,E)
        top_w, top_ids = _by_rows(lambda g: _top_k(g, k), gates,
                                  n_out=2)                       # (B,S,k)
    with _span("moe.sort"):
        dest, kept = _by_rows(lambda ids: _expert_slots(ids, e, c),
                              top_ids, n_out=2)
    with _span("moe.dispatch"):
        tok, = _by_rows(lambda d: _slot_tokens(d, s, k, e, c), dest,
                        n_out=1)
        if not is_sharded(x):
            xz = torch.cat([x, x.new_zeros(b, 1, m)], dim=1)
            xin = xz.gather(1, tok[..., None].expand(b, e * c, m))
            xin = xin.reshape(b, e, c, m)
            if shard_acts:
                xin = constrain(xin, "batch", "act_expert", None, None)
    with _span("moe.experts"):
        we1, we3, we2 = (w.to(x.dtype) for w in (we1, we3, we2))
        if is_sharded(x):
            h = _local_dispatch_and_up(x, tok, we1, we3, c, shard_acts)
            with _span("moe.combine"):
                return _local_down_and_combine(h, we2, dest, kept, top_w,
                                               x, c)
        h = F.silu(torch.einsum("becm,emf->becf", xin, we1))
        h = h * torch.einsum("becm,emf->becf", xin, we3)
        del xz, xin   # a step without grads frees the dispatch's copies
        if shard_acts:
            h = constrain(h, "batch", "act_expert", None, "act_ff")
        out = torch.einsum("becf,efm->becm", h, we2).reshape(b, e * c, m)
    with _span("moe.combine"):
        # each assignment's output, weighted, summed over its token's k
        src = torch.where(kept, dest, 0)
        w = torch.where(kept, top_w.reshape(b, s * k), 0.0).to(out.dtype)
        parts = out.gather(1, src[..., None].expand(b, s * k, m)) \
            * w[..., None]
        y = parts.reshape(b, s, k, m).sum(dim=2, dtype=torch.float32)
    return y.to(x.dtype)


def _nbytes(t: torch.Tensor) -> int:
    """Bytes of DTensor ``t``'s local shard."""
    return t.to_local().numel() * t.element_size()


def _fsdp_layout(n: int, h: int, w: int, y: int, rows_split: bool,
                f_free: bool) -> str:
    """How the MoE's down-projection runs over a mesh dim of size ``n``
    that splits we2's M (FSDP's ``embed``) and neither E nor F, from the
    bytes of the local shards of the hidden (``h``), of we2 (``w``) and of
    the token output split as the rows are (``y``), whichever moves the
    fewest bytes, as the dry run counts a device's: ``"gather_w"`` (we2
    gathered, as FSDP does: n * w), ``"gather_h"`` (h's rows gathered,
    each rank makes its slice of M for every row: n * h where the rows are
    split there, and y to put the rows back) or, where F is split over no
    mesh dim (``f_free``), ``"split_f"`` (h's and we2's F split over it in
    place of the rows and of M, the output a partial sum: h, w and y).
    Training and prefill gather we2; a decode step, whose hidden is
    small, gathers h or splits F."""
    cost = {"gather_w": n * w, "gather_h": (n * h if rows_split else 0) + y}
    if f_free:
        cost["split_f"] = (h if rows_split else 0) + w + y
    return min(cost, key=cost.get)


def _fsdp_up_layout(n: int, x: int, t: int, w: int, h: int,
                    rows_split: bool) -> str:
    """How the MoE's up-projections run over a mesh dim of size ``n`` that
    splits we1's and we3's M (FSDP's ``embed``) and neither E nor F, from
    the bytes of the local shards of the tokens ``x``, of the slot tokens'
    ids ``t``, of one weight ``w`` and of the hidden ``h``, whichever moves
    the fewest bytes, as the dry run counts a device's: ``"gather_w"`` (we1
    and we3 gathered, as FSDP does: 2 n w) or ``"split_m"`` (each rank
    takes its slice of M of every row, the rows exchanged for it (x) and
    the ids gathered (n t) where the rows are split there, and reduces the
    two products' partial sums once each: 2 h).  Training and prefill
    gather the weights; a decode step, whose hidden is small, splits M."""
    cost = {"gather_w": 2 * n * w,
            "split_m": (x + n * t if rows_split else 0) + 2 * h}
    return min(cost, key=cost.get)


def _on_dim(p, dim: int):
    """Shard placement ``p`` (plain or strided) moved to tensor dim
    ``dim``."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    return _StridedShard(dim, split_factor=p.split_factor) \
        if isinstance(p, _StridedShard) else Shard(dim)


def _local_bytes(shape, mesh, pls, itemsize: int) -> int:
    """Bytes of the local shard of a tensor of ``shape`` laid out as
    ``pls`` on ``mesh``."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    local, _ = compute_local_shape_and_global_offset(
        torch.Size(shape), mesh, list(pls))
    return math.prod(local) * itemsize


class _DispatchUp(torch.autograd.Function):
    """A rank's MoE dispatch and up-projections on local tensors: x's rows
    (B, S, M) and a zero row after them, gathered expert-major into the
    slots (``idx``: each slot's row, the zero row for an empty slot) and
    multiplied by each weight of ``ws`` (E, M, F), a ``bmm`` each; out
    comes (silu(a1) * a3,) under ``gate`` (ws = we1, we3), else each
    product, (E, B * C, F).  It saves x's rows, the index and (under
    ``gate``) a1 and a3, not the gathered tokens: the backward gathers them
    again for the weights' grads and scatter-adds their grad, [d a1, d a3]
    @ [we1, we3]ᵀ in one product, into zeros of x's rows.  Its products
    count autograd's FLOPs."""

    @staticmethod
    def forward(ctx, x, idx, gate, *ws):
        xin = _slot_rows(x, idx, ws[0].shape[0])
        outs = [torch.bmm(xin, w) for w in ws]
        del xin
        ctx.gate = gate
        ctx.save_for_backward(x, idx, *ws, *(outs if gate else ()))
        return (F.silu(outs[0]) * outs[1],) if gate else tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        x, idx, *saved = ctx.saved_tensors
        if ctx.gate:
            w1, w3, a1, a3 = saved
            (dh,), ws = grads, (w1, w3)
            ds = (torch.ops.aten.silu_backward(dh * a3, a1),
                  dh * F.silu(a1))
        else:
            ws, ds = saved, grads
        xin = _slot_rows(x, idx, ws[0].shape[0])
        dws = [torch.bmm(xin.transpose(1, 2), d) for d in ds]
        del xin
        # one product over [d a1, d a3] and [we1, we3]: no second buffer
        dxin = torch.bmm(torch.cat(ds, dim=-1), torch.cat(
            ws, dim=-1).transpose(1, 2)) if len(ws) > 1 else \
            torch.bmm(ds[0], ws[0].transpose(1, 2))
        n, m = x.numel() // x.shape[-1], x.shape[-1]
        dx = x.new_zeros(n + 1, m).index_add_(0, idx, dxin.flatten(0, 1))
        return dx[:n].view(x.shape), None, None, *dws


def _slot_rows(x: torch.Tensor, idx: torch.Tensor, e: int) -> torch.Tensor:
    """x's rows (B, S, M), a zero row after them, gathered by ``idx``:
    (E, B * C, M)."""
    flat = x.reshape(-1, x.shape[-1])
    return torch.cat([flat, flat.new_zeros(1, flat.shape[1])]).index_select(
        0, idx).unflatten(0, (e, -1))


def _local_dispatch_and_up(x, tok, we1, we3, c: int, shard_acts: bool
                           ) -> torch.Tensor:
    """``moe_ffn``'s dispatch and expert up-projections under a mesh, on
    each rank's local shards (``on_local_shards``), the counterpart of
    ``_local_down_and_combine``.  Each rank appends a zero row to its
    rows of x (B, S, M), gathers the tokens of its own experts' slots (E
    split: ``act_expert`` took the mesh dim, moonshot) or of all E * C
    slots (F split: ``act_ff`` took it, mixtral), expert-major, and makes
    silu(xin @ we1) * (xin @ we3) on its slice of the weights
    (``_DispatchUp``).  The hidden comes out laid out as the reference
    constrains it, ("batch", "act_expert", None, "act_ff") (with
    ``shard_acts`` off: the rows as x's, E and F as the weights split
    them), a view of the expert-major product that the down-projection
    reads as it lies.  The gathered tokens never leave the body: in the
    backward it scatter-adds their grad into zeros of the rank's rows of x
    (B / data, S, M) and a zero row, and hands x's grad on as a
    ``Partial`` sum over the mesh dims that split E or F, which
    ``moe_ffn`` reduces once, with the router's, to x's placements
    (``grad_placed``).  A mesh dim that splits the weights' M takes
    ``_fsdp_up_layout``'s choice; under ``"split_m"`` each product leaves
    the body as a ``Partial`` sum, reduced once to the hidden's placements
    before the SwiGLU, one product at a time.

    Rounding: x's grad and a partial product are summed across ranks in
    x's dtype, as the programs DTensor chose before did (they all-reduced
    the gathered tokens' cotangent, and reduce-scattered a decode step's
    partial products) and as the reference's compiled program does.
    Without a mesh ``moe_ffn`` does not come here."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = x.device_mesh
    b, s, _ = x.shape
    e, _, f = we1.shape
    shape = (b, e, c, f)
    if shard_acts:
        hp = placements(logical_spec(
            shape, ("batch", "act_expert", None, "act_ff")), mesh)
    else:
        hp = [Shard(1) if type(p) is Shard and p.dim == 0 else
              _on_dim(p, 3) if is_shard(p) and p.dim == 2 else r
              for p, r in zip(we1.placements, rows_of(x))]
    h_bytes = _local_bytes(shape, mesh, hp, x.element_size())
    # per mesh dim: (x, tok, we1/we3, the products) as each layout lays
    # them out; a dim that splits E or F cuts the weights and the hidden
    xp, tp, wp, op, partial = [], [], [], [], []
    for i, (p, w) in enumerate(zip(hp, we1.placements)):
        if is_shard(p) and p.dim in (1, 3):
            cut = Shard(0) if p.dim == 1 else _on_dim(p, 2)
            cols = (Replicate(), Replicate(), cut, p)
        elif type(w) is Shard and w.dim == 1 and _fsdp_up_layout(
                mesh.size(i), _nbytes(x), _nbytes(tok), _nbytes(we1),
                h_bytes, is_shard(p)) == "split_m":
            cols = (Shard(2), Replicate(), w, Partial())
            partial.append(i)
        else:
            cols = (p, p, Replicate(), p)
        for out, pl in zip((xp, tp, wp, op), cols):
            out.append(pl)
    lo, hi = (i * c for i in shard_bounds(shape, mesh, hp, 1))

    def body(xl, tl, *wls):
        bl, el = xl.shape[0], wls[0].shape[0]
        # each slot's row of x's rows, flat; an empty slot's the zero row
        rows = torch.arange(bl, device=tl.device)[:, None] * s
        idx = torch.where(tl[:, lo:hi] < s, tl[:, lo:hi] + rows, bl * s)
        idx = idx.unflatten(1, (el, c)).transpose(0, 1).flatten()
        out, = _DispatchUp.apply(xl, idx, not partial, *wls)
        # (E, B * C, F) -> (B, E, C, F): a view of the expert-major product,
        # a copy (reduced next) where it is a partial sum
        out = out.unflatten(1, (bl, c)).transpose(0, 1)
        return out.contiguous() if partial else out

    if not partial:
        return on_local_shards(body, [(x, xp), (tok, tp), (we1, wp),
                                      (we3, wp)], [op])[0]
    # each partial product made and reduced in turn: one in memory at once
    if tuple(x.placements) != tuple(xp):
        x = x.redistribute(mesh, xp)
    if tuple(tok.placements) != tuple(tp):
        tok = tok.redistribute(mesh, tp)
    a = []
    for w in (we1, we3):
        part, = on_local_shards(body, [(x, xp), (tok, tp), (w, wp)], [op])
        a.append(part.redistribute(mesh, hp))
        del part
    return F.silu(a[0]) * a[1]


class _Combine(torch.autograd.Function):
    """The MoE combine on a rank's local tensors: y (B, S, M), each token's
    sum over its k assignments of the weight ``w`` (B, S, k) times the row
    ``row`` (B, S, k) of ``out`` (N, M), the rank's expert outputs a slot a
    row, in fp32, one k at a time, cast to out's dtype once; an assignment
    of another rank's slot (row -1) adds zero.  Backward: each slot holds
    one assignment at most, so its row of out's grad is that assignment's
    weight times its token's row of dy, one gather, where autograd would
    scatter-add into zeros of every slot; a weight's grad is its row's dot
    with dy.  Each value is autograd's."""

    @staticmethod
    def forward(ctx, out, w, row):
        b, s, k = row.shape
        src = row.clamp(min=0)
        y = None
        for j in range(k):
            part = out.index_select(0, src[:, :, j].flatten()).view(
                b, s, -1).mul_(w[:, :, j, None])
            y = part.float() if y is None else y.add_(part)
            del part     # one assignment's (B, S, M) at a time
        ctx.save_for_backward(out, w, row)
        return y.to(out.dtype)

    @staticmethod
    def backward(ctx, dy):
        out, w, row = ctx.saved_tensors
        b, s, k = row.shape
        n = out.shape[0]
        dout = dw = None
        if ctx.needs_input_grad[1]:     # first: its rows are gone by dout
            src = row.clamp(min=0)
            dw = torch.stack([(dy * out.index_select(
                0, src[:, :, j].flatten()).view(b, s, -1)).sum(-1)
                for j in range(k)], dim=-1)
        if ctx.needs_input_grad[0]:
            # each slot's token row of dy and weight (an empty slot's: 0)
            at = torch.where(row >= 0, row, n).flatten()
            tokens = torch.arange(b * s, device=row.device)
            slot_tok = row.new_zeros(n + 1).scatter_(
                0, at, tokens.repeat_interleave(k))[:n]
            slot_w = w.new_zeros(n + 1).scatter_(0, at, w.flatten())[:n]
            dout = dy.reshape(b * s, -1).index_select(0, slot_tok).mul_(
                slot_w[:, None])
        return dout, dw, None


def _local_down_and_combine(h, we2, dest, kept, top_w, x, c: int
                            ) -> torch.Tensor:
    """``moe_ffn``'s expert down-projection and combine under a mesh, on
    each rank's local shards (``on_local_shards``).  Both are linear in the
    hidden ``h`` (B, E, C, F), so a rank that holds a slice of F (``act_ff``
    took the mesh dim: mixtral's 8 experts do not divide ``model``) or of
    E (``act_expert`` took it: moonshot's 64) multiplies its slice by the
    matching slice of ``we2``, gathers each assignment's slot, weights it
    and sums over k in fp32, one k at a time, and hands on a ``Partial``
    sum of the (B, S, M) token output.  An assignment whose slot lies in
    another rank's experts adds zero here.  The (B, E * C, M) product is
    never reduced nor gathered: the token output is reduced once, to x's
    placements.  A mesh dim that splits we2's M takes ``_fsdp_layout``'s
    choice.

    Rounding: each rank's fp32 sum is cast to x's dtype before the sum
    across ranks, as the program DTensor chose before did (it reduced the
    bf16 product) and as the reference's compiled program does.  Without
    a mesh ``moe_ffn`` does not come here."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = h.device_mesh
    _, s, k = top_w.shape
    # the mesh dims that split E (h's dim 1) or F (dim 3): we2's dim 0 or 1
    cut = {i: p.dim for i, p in enumerate(h.placements)
           if type(p) is Shard and p.dim in (1, 3)}
    rows = rows_of(h)
    f_free = 3 not in cut.values()
    layout = {}
    for i, p in enumerate(we2.placements):
        if i not in cut and type(p) is Shard and p.dim == 2:
            n = mesh.size(i)
            layout[i] = _fsdp_layout(
                n, _nbytes(h), _nbytes(we2), _nbytes(x), is_shard(rows[i]),
                f_free and h.shape[3] % n == 0)
            f_free = f_free and layout[i] != "split_f"
    # per mesh dim: (h, we2, the routing's rows, y) as each layout lays
    # them out; a dim that splits E or F cuts h and we2 and sums y
    pls = {"gather_w": lambda r: (r, Replicate(), r, r),
           "gather_h": lambda r: (Replicate(), Shard(2), Replicate(),
                                  Shard(2)),
           "split_f": lambda r: (Shard(3), Shard(1), Replicate(),
                                 Partial())}
    cols = [(Shard(cut[i]), Shard(0 if cut[i] == 1 else 1), r, Partial())
            if i in cut else pls[layout.get(i, "gather_w")](r)
            for i, r in enumerate(rows)]
    hp, wp, rp, yp = (list(t) for t in zip(*cols))
    lo, hi = (i * c for i in shard_bounds(h.shape, mesh, hp, 1))

    def body(hl, w2l, dl, kl, twl):
        bl, el = hl.shape[:2]
        # (B, E, C, F) -> (E, B * C, F): a view where h is the up body's
        out = torch.bmm(hl.transpose(0, 1).reshape(el, bl * c, -1),
                        w2l).flatten(0, 1)
        # each assignment's row of out, expert-major; not this rank's: -1
        rel = dl - lo
        row = torch.where(
            kl & (rel >= 0) & (dl < hi), (rel // c) * (bl * c) + torch.arange(
                bl, device=dl.device)[:, None] * c + rel % c, -1)
        w = torch.where(row >= 0, twl.reshape(bl, s * k), 0.0).to(out.dtype)
        y = _Combine.apply(out, w.unflatten(1, (s, k)),
                           row.unflatten(1, (s, k)))
        return y.to(x.dtype)

    y, = on_local_shards(body, [(h, hp), (we2, wp), (dest, rp),
                                (kept, rp), (top_w, rp)], [yp])
    return y.redistribute(mesh, [Replicate() if p.is_partial() else p
                                 for p in x.placements])
