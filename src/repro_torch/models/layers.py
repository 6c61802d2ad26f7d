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
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils._pytree import tree_leaves
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..kernels import ops
from ..kernels._build import wide
from ..parallel.sharding import (all_reduce_over, constrain, current_ctx,
                                 is_shard, is_sharded, logical_spec,
                                 on_local_shards, placements, reentered,
                                 replicate_as, shard_bounds)

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


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  On a DTensor table the token ids are replicated
    first (4 bytes a token): torch 2.11's DTensor rules take no dim sharded
    over two mesh axes, as the batch is over (pod, data) on the 2x16x16
    mesh.  Where a graph is recorded the lookup is ``F.embedding``, whose
    backward DTensor shards (2.11's rule for the indexing's backward,
    ``index_put``, raises); without one it is the indexing, as 2.11's
    ``embedding`` rule fails on the 3-D mesh.  The rows of a vocab-sharded
    table come back as a masked partial sum, which DTensor can reduce only
    once, so the lookup is laid out over the batch at once: a model may
    read its embeddings twice (hymba's norm and residual)."""
    if not is_sharded(table):
        return table[tokens]
    ids = constrain(tokens, *(None,) * tokens.dim())
    out = F.embedding(ids, table) if torch.is_grad_enabled() else table[ids]
    return constrain(out, "batch", *(None,) * (tokens.dim() - 1),
                     "act_embed")


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
    is one of the local rows."""
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
    as the reference does (layers.py:262, 272).

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
    dev = x.device
    with _span("moe.router"):
        with _no_batch_dims():
            logits = torch.einsum("bsm,me->bse", x.float(),
                                  router_w.float())
        gates = torch.softmax(logits, dim=-1)                    # (B,S,E)
        top_w, top_ids = torch.topk(gates, k, dim=-1)            # (B,S,k)
        top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    with _span("moe.sort"):
        flat_ids = top_ids.reshape(b, s * k)
        sid, order = torch.sort(flat_ids, dim=-1, stable=True)
        # rank within expert: position - first position of this expert id
        experts = replicate_as(
            torch.arange(e, device=dev).expand(b, e).contiguous(), x)
        first = torch.searchsorted(sid, experts)
        flat = replicate_as(torch.arange(s * k, device=dev), x)
        rank = flat - first.gather(1, sid)
        slot = torch.empty_like(rank).scatter_(1, order, rank)  # flat order
        kept = slot < c
        flat = flat.expand(b, s * k)
        dest = torch.where(kept, flat_ids * c + slot, e * c + flat)
    with _span("moe.dispatch"):
        # the token of each (expert, slot); an empty slot reads row s, zeros
        tok = replicate_as(torch.full((b, e * c + s * k), s,
                                      dtype=torch.long, device=dev), x)
        tok = tok.scatter_(1, dest, flat // k)[:, :e * c]
        xz = torch.cat([x, x.new_zeros(b, 1, m)], dim=1)
        xin = xz.gather(1, tok[..., None].expand(b, e * c, m))
        xin = xin.reshape(b, e, c, m)
        if shard_acts:
            xin = constrain(xin, "batch", "act_expert", None, None)
    with _span("moe.experts"):
        we1, we3, we2 = (w.to(x.dtype) for w in (we1, we3, we2))
        h = F.silu(torch.einsum("becm,emf->becf", xin, we1))
        h = h * torch.einsum("becm,emf->becf", xin, we3)
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
