"""The port's checkpointing: twins of tests/test_checkpoint.py, and
checkpoints that either package writes restored, bit for bit, by the
other."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpointing import CheckpointManager as JaxManager
from repro.checkpointing import load_checkpoint as jax_load
from repro.checkpointing import save_checkpoint as jax_save
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import get_model as jax_get_model
from repro.optimizer import adamw_init as jax_adamw_init
from repro_torch.checkpointing import (CheckpointManager, Template,
                                       load_checkpoint, save_checkpoint)
from repro_torch.configs import get_smoke_config
from repro_torch.models import get_model, make_train_step
from repro_torch.models.convert import params_from_numpy
from repro_torch.optimizer import AdamWState, adamw_init


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((8, 4), generator=g),
                   "b": torch.zeros((4,), dtype=torch.bfloat16)},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _like(tree):
    if isinstance(tree, dict):
        return {k: _like(v) for k, v in tree.items()}
    return Template(tuple(tree.shape), tree.dtype)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, AdamWState):
        return [tree.step, *_leaves(tree.mu), *_leaves(tree.nu)]
    return [tree]


# ------------------------------------------ twins of test_checkpoint.py --
def test_roundtrip(tmp_path):
    tree = _tree()
    save_checkpoint(tmp_path, 100, tree)
    got = load_checkpoint(tmp_path, 100, _like(tree))
    for a, b in zip(_leaves(tree), _leaves(got)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_manager_latest_and_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for step in (1, 2, 3):
        mgr.save(step, _tree(step))
    assert mgr.latest() == 3
    assert mgr.steps() == [2, 3]  # gc keeps 2


def test_async_save_then_restore(tmp_path):
    mgr = CheckpointManager(tmp_path)
    tree = _tree(1)
    saved = tree["params"]["w"].clone()
    mgr.async_save(5, tree)
    tree["params"]["w"].add_(1.0)  # the snapshot was taken at the call
    mgr.wait()
    step, got = mgr.restore(_like(tree))
    assert step == 5
    assert torch.equal(got["params"]["w"], saved)


def test_incomplete_checkpoint_ignored(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _tree())
    # simulate a crash mid-save of step 2: manifest says WRITING
    d = tmp_path / "step_00000002"
    d.mkdir()
    (d / "MANIFEST.json").write_text(json.dumps(
        {"step": 2, "status": "WRITING", "leaves": []}))
    assert mgr.latest() == 1  # restart rolls back to the COMPLETE one
    with pytest.raises(ValueError, match="incomplete"):
        load_checkpoint(tmp_path, 2, {})


def test_restore_rejects_shape_mismatch(tmp_path):
    save_checkpoint(tmp_path, 1, {"w": torch.zeros((4,))})
    with pytest.raises(ValueError, match="shape mismatch"):
        load_checkpoint(tmp_path, 1, {"w": Template((5,), torch.float32)})
    with pytest.raises(ValueError, match="leaves"):
        load_checkpoint(tmp_path, 1, {"w": Template((4,), torch.float32),
                                      "v": Template((4,), torch.float32)})


def test_restore_missing_raises(tmp_path):
    mgr = CheckpointManager(tmp_path)
    with pytest.raises(FileNotFoundError):
        mgr.restore({"w": Template((1,), torch.float32)})


def test_checkpoint_restart_training_equivalence(tmp_path):
    """Train 4 steps straight == train 2, checkpoint, restore, train 2."""
    cfg = get_smoke_config("llama3.2-1b")
    model = get_model(cfg)
    step = make_train_step(model, lr_schedule=1e-3)
    toks = torch.randint(0, cfg.vocab_size, (2, 33),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    p = model.init(torch.Generator().manual_seed(0))
    o = adamw_init(p)
    ps, os_ = p, o
    for _ in range(4):
        ps, os_, _ = step(ps, os_, batch)
    pa, oa = p, o
    for _ in range(2):
        pa, oa, _ = step(pa, oa, batch)
    mgr = CheckpointManager(tmp_path)
    mgr.save(2, {"params": pa, "opt": oa})
    # the template as tensors: each leaf restores in its dtype and device
    _, restored = mgr.restore({"params": p, "opt": o})
    pb, ob = restored["params"], restored["opt"]
    assert isinstance(ob, AdamWState) and int(ob.step) == 2
    assert list(pb) == list(p)
    for _ in range(2):
        pb, ob, _ = step(pb, ob, batch)
    for k in ps:
        torch.testing.assert_close(pb[k], ps[k], rtol=1e-5, atol=1e-6)


# ------------------------------------------------------ across packages --
def _smoke_trees():
    """The smoke llama3.2-1b's {"params", "opt"} in both packages, from one
    set of JAX weights, with each package's AdamW state after one update of
    the same grads, and a bf16 leaf beside them."""
    from repro.optimizer import adamw_update as jax_update
    from repro_torch.optimizer import adamw_update

    jm = jax_get_model(jax_smoke_config("llama3.2-1b"))
    jp = jm.init(jax.random.PRNGKey(0))
    arrays = {k: np.asarray(v) for k, v in jp.items()}
    grads = {k: np.random.default_rng(1).standard_normal(a.shape).astype(
        np.float32) for k, a in arrays.items()}
    jp, jo = jax_update(jp, {k: jnp.asarray(g) for k, g in grads.items()},
                        jax_adamw_init(jp), 1e-3)
    tp = params_from_numpy(arrays, "cpu")
    tp, to = adamw_update(tp, params_from_numpy(grads, "cpu"),
                          adamw_init(tp), 1e-3)
    half = np.random.default_rng(2).standard_normal((3, 5)).astype(np.float32)
    jtree = {"params": jp, "opt": jo,
             "half": jnp.asarray(half, jnp.bfloat16)}
    ttree = {"params": tp, "opt": to,
             "half": torch.from_numpy(half).to(torch.bfloat16)}
    return jtree, ttree


def _manifest(path, step):
    return json.loads((path / f"step_{step:08d}" / "MANIFEST.json")
                      .read_text())


def test_the_manifests_agree_leaf_for_leaf(tmp_path):
    jtree, ttree = _smoke_trees()
    jax_save(tmp_path / "jax", 3, jtree)
    save_checkpoint(tmp_path / "port", 3, ttree)
    jm, tm = _manifest(tmp_path / "jax", 3), _manifest(tmp_path / "port", 3)
    assert tm["leaves"] == jm["leaves"]
    assert tm["treedef"] == jm["treedef"]
    assert (tm["step"], tm["status"]) == (jm["step"], jm["status"]) == \
        (3, "COMPLETE")
    paths = [e["path"] for e in tm["leaves"]]
    assert paths[:3] == ["['half']", "['opt']/.step",
                         "['opt']/.mu/['embed.w']"]
    assert paths[-1] == "['params']/['layers.mlp_norm.w']"
    assert len(paths) == 38  # the 37 of {"params", "opt"}, and "half"
    assert tm["leaves"][0]["dtype"] == "bfloat16"
    assert tm["leaves"][1]["shape"] == [] and \
        tm["leaves"][1]["dtype"] == "int32"


def test_a_checkpoint_written_by_jax_restores_in_the_port(tmp_path):
    jtree, ttree = _smoke_trees()
    mgr = JaxManager(tmp_path)
    mgr.save(4, jtree)
    step, got = CheckpointManager(tmp_path).restore(_like_port(ttree))
    assert step == 4
    want = jax.tree_util.tree_leaves(jtree)
    got_leaves = _leaves(got)
    assert len(got_leaves) == len(want) == 38
    for g, w in zip(got_leaves, want):
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
        np.testing.assert_array_equal(_bits(g), np.asarray(w).view(
            np.uint16) if w.dtype == jnp.bfloat16 else np.asarray(w))


def test_a_checkpoint_written_by_the_port_restores_in_jax(tmp_path):
    jtree, ttree = _smoke_trees()
    CheckpointManager(tmp_path).save(4, ttree)
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        jtree)
    step, got = JaxManager(tmp_path).restore(like)
    assert step == 4
    got_leaves = jax.tree_util.tree_leaves(got)
    for g, t in zip(got_leaves, _leaves(ttree)):
        assert str(g.dtype) == str(t.dtype).removeprefix("torch.")
        want = _bits(t)
        np.testing.assert_array_equal(np.asarray(g).view(np.uint16) if
                                      g.dtype == jnp.bfloat16 else
                                      np.asarray(g), want)


def _like_port(tree):
    if isinstance(tree, AdamWState):
        return AdamWState(_like(tree.step), _like(tree.mu), _like(tree.nu))
    if isinstance(tree, dict):
        return {k: _like_port(v) for k, v in tree.items()}
    return _like(tree)


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def test_jax_restores_the_port_tree_into_its_own_structure(tmp_path):
    """The leaf order is JAX's: JAX's load_checkpoint unflattens the port's
    leaves into its own tree by position, so a wrong order would put each
    moment under another parameter's name (caught by the values)."""
    jtree, ttree = _smoke_trees()
    save_checkpoint(tmp_path, 1, ttree)
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        jtree)
    got = jax_load(tmp_path, 1, like)
    for name, want in ttree["opt"].nu.items():
        np.testing.assert_array_equal(np.asarray(got["opt"].nu[name]),
                                      want.numpy())
    np.testing.assert_array_equal(np.asarray(got["params"]["embed.w"]),
                                  ttree["params"]["embed.w"].numpy())
