"""The port's ``layers.attention`` alone on bf16 DTensors of a 4-rank gloo
world, a (data=2, model=2) mesh as tests/test_torch_sharded.py builds it,
against the unsharded port and JAX's layer, on the CPU.

The layouts: 4 q over 2 kv heads (both shard over ``model``; a rank sums
its own group), 6 q over 3 (3 kv heads do not split in 2: they replicate
over ``model`` and each rank picks its q heads' kv heads by a list, one
of them twice) and 1 kv head (replicated, a rank's 2 q heads take it by a
slice).  Each runs the dense causal path and the q-chunked block-skipping
path with a window (``dense_max_seq`` 64, chunks of 64).  Where kv heads
replicate, every model rank holds a part of their grads: a ``Partial`` sum.

Fault E's repair on a mesh: the pick's backward sums a kv head's grads
over its q heads in fp32, the ranks' parts are reduced in fp32, and each
value is rounded to bf16 once (``sharding.widened``).  Held here: bf16
dq, dk and dv, gathered, within 1e-4 relative Frobenius of the unsharded
port's and of JAX's; and every reduction of the backward (DTensor's
all-reduce or reduce-scatter on the local tensors) runs in fp32, one for
each of dk and dv where kv heads replicate and none where they shard.
B = 4, S = 256 and D = 64, so that each grad holds 65536 values or more:
a value rounded to the other side of a bf16 tie, one ulp, moves the
distance by well under 1e-4.  The same numpy draws, rounded to bf16 once,
go to every side.
"""
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.models import layers
from repro_torch.parallel.sharding import place, use_sharding

WORLD, B, S, D, CHUNK = 4, 4, 256, 64, 64
RANKS_TIMEOUT_S = 300
TOL = 1e-4              # relative Frobenius, a grad
# layout -> (q heads, kv heads)
LAYOUTS = {"4q2kv-sharded": (4, 2), "6q3kv-list-pick": (6, 3),
           "4q1kv-slice-pick": (4, 1)}
# path -> layers.attention's keywords
PATHS = {"dense": dict(causal=True),
         "chunked-skip": dict(causal=True, window=96, dense_max_seq=CHUNK,
                              chunk=CHUNK, block_skip=True)}
CASES = [(lay, path) for lay in LAYOUTS for path in PATHS]
NAMES = ("batch", "act_heads", None, None)


def _draws(layout: str) -> list:
    """q, k, v and the cotangent, rounded to bf16 once, as fp32 numpy."""
    hq, hkv = LAYOUTS[layout]
    rng = np.random.default_rng(hq * 10 + hkv)
    return [torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).bfloat16().float().numpy()
        for s in ((B, hq, S, D), (B, hkv, S, D), (B, hkv, S, D),
                  (B, hq, S, D))]


def _port(arrays, kw, mesh=None) -> list:
    """bf16 dq, dk, dv of the port's layer (gathered under ``mesh``)."""
    with use_sharding(mesh):
        q, k, v, g = (place(torch.from_numpy(a).bfloat16(), NAMES)
                      for a in arrays)
        qkv = [t.requires_grad_() for t in (q, k, v)]
        out = layers.attention(*qkv, **kw)
        if mesh is not None:
            g = g.redistribute(mesh, out.placements)
        grads = torch.autograd.grad(out, qkv, g)
    out = []
    for t in grads:
        assert t.dtype == torch.bfloat16
        t = t.full_tensor() if hasattr(t, "full_tensor") else t
        out.append(t.float().numpy())
    return out


class _Reductions(TorchDispatchMode):
    """The dtypes of the all-reduces and reduce-scatters DTensor issues on
    the local tensors while open."""

    def __init__(self):
        super().__init__()
        self.dtypes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func._overloadpacket in (
                torch.ops._c10d_functional.all_reduce,
                torch.ops._c10d_functional.reduce_scatter_tensor):
            self.dtypes.append(str(args[0].dtype))
        return func(*args, **(kwargs or {}))


def _rank_main(rank: int, tmp: str) -> None:
    """One of the 4 gloo ranks: every case's gathered grads and the dtypes
    of its backward's reductions, written to ``rank{rank}_{case}.npz``."""
    from torch.distributed.device_mesh import DeviceMesh

    torch.set_num_threads(1)
    tmp = Path(tmp)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp / "store"), WORLD), rank=rank, world_size=WORLD)
    try:
        mesh = DeviceMesh("cpu", torch.arange(WORLD).reshape(2, 2),
                          mesh_dim_names=("data", "model"))
        for layout, path in CASES:
            arrays = _draws(layout)
            with _Reductions() as red:
                grads = _port(arrays, PATHS[path], mesh)
            np.savez(tmp / f"rank{rank}_{layout}_{path}.npz", *grads,
                     reductions=np.asarray(red.dtypes, dtype=str))
    finally:
        dist.destroy_process_group()


def _jax(arrays, kw) -> list:
    import jax
    import jax.numpy as jnp

    from repro.models import layers as jlayers

    pos = jnp.arange(S)

    @jax.jit
    def grads(q, k, v, g):
        return jax.vjp(lambda q, k, v: jlayers.attention(
            q, k, v, q_pos=pos, k_pos=pos, **kw), q, k, v)[1](g)

    return [np.asarray(t.astype(jnp.float32)) for t in grads(
        *(jnp.asarray(a, jnp.bfloat16) for a in arrays))]


def _run_all(tmp: Path) -> dict:
    """case -> {"sharded": rank 0's grads, "reductions": their dtypes,
    "port": the unsharded port's, "jax": JAX's}.  The ranks run while this
    process computes both references."""
    ranks = mp.start_processes(_rank_main, args=(str(tmp),), nprocs=WORLD,
                               join=False, start_method="spawn")
    out = {}
    for layout, path in CASES:
        arrays = _draws(layout)
        out[layout, path] = {"port": _port(arrays, PATHS[path]),
                             "jax": _jax(arrays, PATHS[path])}
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    while not ranks.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ranks.processes:
                p.kill()
            raise TimeoutError(f"the {WORLD} ranks ran past "
                               f"{RANKS_TIMEOUT_S} s")
    for layout, path in CASES:
        got = [dict(np.load(tmp / f"rank{r}_{layout}_{path}.npz"))
               for r in range(WORLD)]
        for other in got[1:]:   # every rank gathers the same grads
            assert all(np.array_equal(other[k], got[0][k]) for k in other)
        out[layout, path].update(
            sharded=[got[0][f"arr_{i}"] for i in range(3)],
            reductions=list(got[0]["reductions"]))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory) -> dict:
    return _run_all(tmp_path_factory.mktemp("sharded_attention"))


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    a, b = a.astype(np.float64), b.astype(np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("layout,path", CASES)
def test_bf16_grads_match_unsharded_and_jax(runs, layout, path):
    run = runs[layout, path]
    for name, got, port, want in zip(("dq", "dk", "dv"), run["sharded"],
                                     run["port"], run["jax"]):
        assert _rel(got, port) <= TOL, (name, "port", _rel(got, port))
        assert _rel(got, want) <= TOL, (name, "jax", _rel(got, want))


@pytest.mark.parametrize("layout,path", CASES)
def test_kv_grads_are_reduced_across_ranks_in_fp32(runs, layout, path):
    """One fp32 reduction each for dk and dv where the kv heads replicate
    over ``model``; none where they shard with q's heads."""
    hq, hkv = LAYOUTS[layout]
    want = [] if hkv % 2 == 0 else ["torch.float32"] * 2
    assert runs[layout, path]["reductions"] == want


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=src python
    # tests/test_torch_sharded_attention.py: each case's distances, (dq,
    # dk, dv) each as [the sharded from the unsharded port, the sharded
    # from JAX, the unsharded port from JAX], and the dtypes of the
    # backward's reductions
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        for (layout, path), run in _run_all(Path(tmp)).items():
            print(layout, path, " ".join(
                f"[{_rel(a, b):.2e} {_rel(a, c):.2e} {_rel(b, c):.2e}]"
                for a, b, c in zip(run["sharded"], run["port"],
                                   run["jax"])), run["reductions"])
