"""The port's main path (``repro_torch.mixed_mode``) on the CPU at tiny
shapes, against the JAX package's ops on the same numpy operands.

Tolerances: bf16 matmul rtol=2e-2, atol=0.2 (test_kernels.py's bf16
tolerance: one bf16 rounding of the output); copy and sort exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch import mixed_mode as mm
from repro_torch.core import random_dag

TINY = {"matmul": (128, 128), "sort": (8, 128), "copy": (256, 128)}
N_CHUNKS = mm.N_CHUNKS


@pytest.mark.parametrize("policy", mm.POLICIES)
def test_run_completes_every_chunk_exactly_once(policy):
    log = mm.ChunkLog()
    out = mm.run(policy, n_tasks=60, device="cpu", shapes=TINY,
                 timeout_s=60.0, log=log)
    assert out["completed"] == 60
    assert len(log.runs) == 60 * N_CHUNKS
    assert set(log.runs.values()) == {1}
    records = log.records
    assert len(records) == 60                   # one leader update per TAO
    assert all(0 <= r.leader_chunks <= N_CHUNKS for r in records)
    if policy == "homogeneous":                 # width 1: the leader runs all
        assert {(r.width, r.leader_chunks) for r in records} == {
            (1, N_CHUNKS)}
    for cls in TINY:
        assert (out["ptt"][cls] > 0).any()


def test_run_without_a_log_leaves_the_runtime_unwrapped(monkeypatch):
    """Without a log the chunks are the bare ops and the core's PTT update
    is its own method: the check instrumentation costs the run nothing."""
    seen = []
    make = mm.ChunkedWork

    def spy(fn, n_chunks):
        seen.append(fn.__qualname__)
        return make(fn, n_chunks=n_chunks)

    monkeypatch.setattr(mm, "ChunkedWork", spy)
    watch = mm.ChunkLog.watch
    monkeypatch.setattr(mm.ChunkLog, "watch", lambda self, core: (
        seen.append("watch"), watch(self, core)))
    out = mm.run("molding:weight", n_tasks=30, device="cpu", shapes=TINY,
                 timeout_s=60.0)
    assert out["completed"] == 30
    assert len(seen) == 30 and "watch" not in seen
    assert not any("logged" in name for name in seen)
    for cls in TINY:
        assert (out["ptt"][cls] > 0).any()


def test_operands_round_like_jax():
    arrays = mm.make_arrays(TINY, seed=3)
    operands = mm.operands_from_numpy(arrays, "cpu")
    for cls, a in arrays.items():
        want = np.asarray(jnp.asarray(a, getattr(jnp, str(
            mm.DTYPES[cls]).removeprefix("torch."))), np.float32)
        np.testing.assert_array_equal(operands[cls].float().numpy(), want)


def test_chunk_outputs_match_the_jax_ops():
    """One chunk of each class against the JAX op the example runs, with the
    Pallas kernel in interpret mode, on the same numpy operands."""
    arrays = mm.make_arrays(TINY, seed=4)
    operands = mm.operands_from_numpy(arrays, "cpu")
    dag = random_dag(n_tasks=3, target_degree=1.0, seed=0)
    assert sorted(n.type for n in dag.nodes) == ["copy", "matmul", "sort"]
    mm.bind_real_work(dag, operands, device="cpu", n_chunks=2)
    xm = jnp.asarray(arrays["matmul"], jnp.bfloat16)
    want = {
        "matmul": jops.matmul(xm, xm, force="interpret"),
        "sort": jops.sort_rows(jnp.asarray(arrays["sort"]), force="interpret"),
        "copy": jops.copy(jnp.asarray(arrays["copy"]), force="interpret"),
    }
    for node in dag.nodes:
        got = node.work.chunk_fn(0)
        assert node.work.n_chunks == 2
        assert got.dtype == mm.DTYPES[node.type]
        w = np.asarray(want[node.type], np.float32)
        if node.type == "matmul":
            np.testing.assert_allclose(got.float().numpy(), w, rtol=2e-2,
                                       atol=0.2)
        else:
            np.testing.assert_array_equal(got.numpy(), w)


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        mm.run(n_tasks=3, shapes=TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        mm.main(["--n-tasks", "3"])
    with pytest.raises(RuntimeError, match="CUDA"):
        mm.operands_from_numpy(mm.make_arrays(TINY))
