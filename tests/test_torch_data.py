"""The port's synthetic data pipeline against the JAX package's: the same
batches, bit for bit, for each (seed, step, host)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import SyntheticFrames as JaxFrames
from repro.data import SyntheticLM as JaxLM
from repro_torch.data import SyntheticFrames, SyntheticLM


@pytest.mark.parametrize("seed,host_count", [(0, 1), (3, 1), (0, 2),
                                             (7, 4)])
def test_synthetic_lm_batches_are_jax_bit_for_bit(seed, host_count):
    kw = dict(vocab_size=503, seq_len=33, global_batch=4, seed=seed,
              host_count=host_count)
    port, ref = SyntheticLM(**kw), JaxLM(**kw)
    for step in (0, 1, 17):
        got, want = port.batch(step, device="cpu"), ref.batch(step)
        assert set(got) == set(want) == {"tokens", "targets"}
        for k in got:
            assert got[k].dtype == torch.int32 and got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        np.testing.assert_array_equal(got["tokens"][:, 1:].numpy(),
                                      got["targets"][:, :-1].numpy())
        for h in range(host_count):
            mine = SyntheticLM(**{**kw, "host_index": h}).host_batch(step)
            theirs = JaxLM(**{**kw, "host_index": h}).host_batch(step)
            for k in mine:
                assert mine[k].dtype == np.int32
                np.testing.assert_array_equal(mine[k], theirs[k])


def test_synthetic_lm_rejects_a_batch_the_hosts_cannot_split():
    with pytest.raises(ValueError, match="divide by host_count"):
        SyntheticLM(vocab_size=10, seq_len=4, global_batch=3, host_count=2)


def test_synthetic_lm_batch_needs_a_card_unless_asked_for_the_cpu():
    data = SyntheticLM(vocab_size=10, seq_len=4, global_batch=2)
    if torch.cuda.is_available():
        assert data.batch(0)["tokens"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            data.batch(0)


@pytest.mark.parametrize("seed,step", [(0, 0), (2, 5)])
def test_synthetic_frames_are_jax_bit_for_bit(seed, step):
    kw = dict(d_model=24, seq_len=7, global_batch=3, n_classes=11, seed=seed)
    got = SyntheticFrames(**kw).batch(step, device="cpu")
    want = JaxFrames(**kw).batch(step)
    assert got["frames"].dtype == torch.bfloat16
    assert got["targets"].dtype == torch.int32
    # bf16 as its bits: the rounding to nearest even is the same
    np.testing.assert_array_equal(
        got["frames"].view(torch.int16).numpy().view(np.uint16),
        np.asarray(want["frames"]).view(np.uint16))
    np.testing.assert_array_equal(got["targets"].numpy(),
                                  np.asarray(want["targets"]))
    assert want["frames"].dtype == jnp.bfloat16
