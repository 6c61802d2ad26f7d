"""The port's ``parallel`` layer, mesh, shape table, abstract specs and
example twins on the CPU, against the JAX package.

Tolerances: sharding specs, shapes and dtypes exact; int8 quantization
exact (q, scale and the error feedback bit for bit); the 4-rank
``compressed_psum`` mean at rtol 1e-6 of the float64 mean of JAX's per-rank
wire values, plus the fp32 rounding of a 4-term sum (4 * 2^-24 of the
summed magnitudes), and each rank's new error bit for bit.  The 4-rank
checks run in one module-scoped spawn of 4 gloo processes joined through a
``FileStore`` (no network port).
"""
import contextlib
import functools
import importlib.util
import io
import json
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import repro.configs as jconfigs
import repro.data.pipeline as jpipeline
import repro.models as jmodels
import repro.parallel.collectives as jcoll
import repro.parallel.sharding as jsh
from repro_torch import configs as tconfigs
from repro_torch.core import DataFootprint, LocalityTracker, hikey960
from repro_torch.data import SyntheticLM, make_batch_specs
from repro_torch.examples import multi_tenant, quickstart
from repro_torch.launch.mesh import (make_debug_mesh, make_production_mesh,
                                     mesh_chip_count)
from repro_torch.models import get_model
from repro_torch.parallel import collectives as tcoll
from repro_torch.parallel import sharding as tsh
from repro_torch.parallel.sharding import (LOGICAL_RULES, P, ShardingCtx,
                                           logical_spec, pad_to_multiple,
                                           use_sharding)

ROOT = Path(__file__).resolve().parent.parent
MESHES = {"pod1": {"data": 16, "model": 16},
          "pod2": {"pod": 2, "data": 16, "model": 16}}
# the serve-time weight layout of decode_no_fsdp cells
# (src/repro/launch/dryrun.py:215-225)
DECODE_NO_FSDP = {"embed": (), "ff": ("model", "data"),
                  "heads": ("model", "data"), "kv_heads": ("model", "data"),
                  "vocab": ("model", "data")}
RULES = {"logical": {}, "decode_no_fsdp": DECODE_NO_FSDP}


def _fake_ctx(shape: dict, rules=None) -> ShardingCtx:
    return ShardingCtx(mesh=SimpleNamespace(shape=shape),
                       rules=dict(rules or LOGICAL_RULES))


def _dtype(d) -> str:
    return str(d).split(".")[-1]


def _shape_dtype(x) -> tuple:
    return tuple(x.shape), _dtype(x.dtype)


# ------------------------------------------------- twins of test_sharding.py
def test_divisible_dims_get_sharded():
    ctx = _fake_ctx({"pod": 2, "data": 16, "model": 16})
    spec = logical_spec((256, 4096), ("batch", "seq"), ctx)
    assert spec == P(("pod", "data"))


def test_indivisible_dim_dropped():
    ctx = _fake_ctx({"data": 16, "model": 16})
    spec = logical_spec((4096, 25), ("embed", "heads"), ctx)
    assert spec == P("data")


def test_prefix_order_partial_shard():
    ctx = _fake_ctx({"pod": 2, "data": 16, "model": 16})
    assert logical_spec((32,), ("batch",), ctx) == P(("pod", "data"))
    assert logical_spec((8,), ("batch",), ctx) == P("pod")


def test_axis_never_reused_across_dims():
    ctx = _fake_ctx({"data": 16, "model": 16})
    spec = logical_spec((64, 2048, 1408), ("expert", "embed", "ff"), ctx)
    assert spec == P("model", "data")


def test_no_mesh_means_no_spec():
    assert logical_spec((8, 8), ("batch", "embed"),
                        ShardingCtx(mesh=None, rules={})) == P()


def test_use_sharding_context_manager():
    assert tsh.current_ctx() is None
    with use_sharding(None):
        assert tsh.current_ctx() is not None
    assert tsh.current_ctx() is None


@pytest.mark.parametrize("n,mult,want", [
    (92553, 256, 92672), (128256, 256, 128256), (1, 8, 8), (504, 8, 504)])
def test_pad_to_multiple(n, mult, want):
    assert pad_to_multiple(n, mult) == want


def test_padded_vocab_divisibility_for_all_archs():
    for arch in tconfigs.ARCH_IDS:
        cfg = tconfigs.get_config(arch)
        assert cfg.padded_vocab % 16 == 0 or cfg.vocab_pad_multiple < 16, arch
        assert cfg.padded_vocab >= cfg.vocab_size


# ------------------------------------------------ sharding parity with JAX
@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_param_specs_equal_jax(arch, mesh, rules):
    overrides = RULES[rules]
    shape = MESHES[mesh]
    tctx = ShardingCtx(SimpleNamespace(shape=shape),
                       {**LOGICAL_RULES, **overrides})
    jctx = jsh.ShardingCtx(SimpleNamespace(shape=shape),
                           {**jsh.LOGICAL_RULES, **overrides})
    tdefs = get_model(tconfigs.get_config(arch)).param_defs()
    jdefs = jmodels.get_model(jconfigs.get_config(arch)).param_defs()
    assert sorted(tdefs) == sorted(jdefs)
    for name, d in tdefs.items():
        jd = jdefs[name]
        assert (tuple(d.shape), tuple(d.names)) == \
            (tuple(jd.shape), tuple(jd.names)), name
        got = logical_spec(d.shape, d.names, tctx)
        assert tuple(got) == tuple(jsh.logical_spec(jd.shape, jd.names,
                                                    jctx)), name


def test_logical_rules_are_jax_rules():
    assert LOGICAL_RULES == jsh.LOGICAL_RULES


def test_set_rules_needs_a_context_and_updates_it():
    with pytest.raises(RuntimeError):
        tsh.set_rules({"embed": ()})
    with use_sharding(SimpleNamespace(shape={"data": 4})) as ctx:
        tsh.set_rules({"embed": ()})
        assert ctx.rules["embed"] == ()
        assert tsh.current_ctx().axis_size("data") == 4
    assert LOGICAL_RULES["embed"] == ("data",)


def test_constrain_and_logical_sharding_are_no_ops_outside_a_mesh():
    x = torch.ones(4, 4)
    assert tsh.constrain(x, "batch", "embed") is x
    assert tsh.logical_sharding((4, 4), ("batch", "embed")) is None
    with use_sharding(None):
        assert tsh.constrain(x, "batch", "embed") is x


# ------------------------------------------------------ the cell matrix
def test_shapes_and_cells_equal_jax():
    assert tconfigs.SHAPE_NAMES == jconfigs.SHAPE_NAMES
    for name, s in tconfigs.SHAPES.items():
        j = jconfigs.SHAPES[name]
        assert (s.name, s.kind, s.seq_len, s.global_batch) == \
            (j.name, j.kind, j.seq_len, j.global_batch)
    assert tconfigs.valid_cells() == jconfigs.valid_cells()
    for arch in tconfigs.ARCH_IDS:
        for name in tconfigs.SHAPE_NAMES:
            assert tconfigs.cell_skip_reason(
                tconfigs.get_config(arch), tconfigs.SHAPES[name]) == \
                jconfigs.cell_skip_reason(jconfigs.get_config(arch),
                                          jconfigs.SHAPES[name])


def _tree_shapes(tree) -> object:
    if isinstance(tree, dict):
        return {k: _tree_shapes(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree_shapes(v) for v in tree)
    return _shape_dtype(tree)


@pytest.mark.parametrize("arch,shape", jconfigs.valid_cells()[0],
                         ids=lambda v: str(v))
def test_input_specs_equal_jax(arch, shape):
    got = tconfigs.input_specs(tconfigs.get_config(arch),
                               tconfigs.SHAPES[shape])
    want = jconfigs.input_specs(jconfigs.get_config(arch),
                                jconfigs.SHAPES[shape])
    assert _tree_shapes(got) == _tree_shapes(want)
    # a decode cache's pos is concrete, on the CPU, at decode_pos: the
    # port's decode reads it on the host (ROADMAP.md, Queue 3, fault C)
    pos = got.get("cache", {}).pop("pos", None)
    if pos is not None:
        assert pos.device.type == "cpu" and int(pos) == \
            tconfigs.decode_pos(tconfigs.SHAPES[shape])
    leaves = jax.tree_util.tree_leaves(
        got, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert leaves and all(x.device.type == "meta" for x in leaves)


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_abstract_params_equal_jax(arch):
    got = get_model(tconfigs.get_config(arch)).abstract_params()
    want = jmodels.get_model(jconfigs.get_config(arch)).abstract_params()
    assert list(got) == list(want)
    assert _tree_shapes(got) == _tree_shapes(want)
    assert all(v.device.type == "meta" for v in got.values())


def test_make_batch_specs_mirrors_a_batch():
    tbatch = SyntheticLM(vocab_size=100, seq_len=8, global_batch=2).batch(
        0, device="cpu")
    jbatch = jpipeline.SyntheticLM(vocab_size=100, seq_len=8,
                                   global_batch=2).batch(0)
    got = make_batch_specs(tbatch)
    assert _tree_shapes(got) == _tree_shapes(
        jpipeline.make_batch_specs(jbatch))
    assert all(v.device.type == "meta" for v in got.values())


def test_init_cache_takes_a_device_and_meta_keeps_pos_abstract():
    for arch in ("llama3.2-1b", "mamba2-780m", "hymba-1.5b"):
        model = get_model(tconfigs.get_smoke_config(arch))
        with pytest.raises(TypeError):
            model.init_cache(2, 16)
        meta = model.init_cache(2, 16, device="meta")
        cpu = model.init_cache(2, 16, device="cpu")
        assert _tree_shapes(meta) == _tree_shapes(cpu)
        assert meta["pos"].device.type == "meta"
        assert meta["pos"].shape == () and meta["pos"].dtype == torch.int32
        assert cpu["pos"].device.type == "cpu" and int(cpu["pos"]) == 0


# ----------------------------------------------------------- collectives
QUANT_INPUTS = {
    "normal": lambda: np.random.default_rng(0).standard_normal(1000),
    "small": lambda: np.random.default_rng(1).standard_normal(256) * 0.01,
    # exact half-grid points: amax 127 gives scale 1, so x/scale ties
    "ties": lambda: np.array([127.0, -127.0, 0.5, 1.5, 2.5, -0.5, -2.5,
                              126.5, 0.0, -0.0]),
    "zeros": lambda: np.zeros(16),
    "wide": lambda: np.random.default_rng(2).standard_normal((64, 48)) * 1e3,
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(QUANT_INPUTS))
def test_quantize_int8_equals_jax_bit_for_bit(case, dtype):
    a = QUANT_INPUTS[case]().astype(np.float32)
    tx = torch.from_numpy(a).to(getattr(torch, dtype))
    jx = jnp.asarray(a, getattr(jnp, dtype))
    q, s = tcoll.quantize_int8(tx)
    jq, js = jcoll.quantize_int8(jx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    back = tcoll.dequantize_int8(q, s)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jcoll.dequantize_int8(jq, js)))


def test_quantize_roundtrip_error_bound():
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal(1000).astype(np.float32))
    q, scale = tcoll.quantize_int8(x)
    back = tcoll.dequantize_int8(q, scale)
    assert float((back - x).abs().max()) <= float(scale) * 0.5 + 1e-7


@pytest.mark.parametrize("seed", [0, 1, 17, 4242, 10_000])
def test_quantize_idempotent_on_grid(seed):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        64).astype(np.float32))
    q, s = tcoll.quantize_int8(x)
    q2, _ = tcoll.quantize_int8(tcoll.dequantize_int8(q, s))
    assert torch.equal(q, q2)


def test_compressed_wire_is_half_precision():
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        128).astype(np.float32))
    q, s = tcoll.quantize_int8(x)
    wire = tcoll.dequantize_int8(q, s).to(torch.bfloat16)
    assert wire.dtype == torch.bfloat16
    torch.testing.assert_close(wire.float(), tcoll.dequantize_int8(q, s),
                               rtol=1e-2, atol=float(s) * 0.01)


@functools.lru_cache(maxsize=None)
def _jax_psum():
    """JAX's compressed_psum under shard_map with a trivial 1-device axis
    named 'pod', as tests/test_collectives.py runs it, jitted once."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec
    mesh = jax.make_mesh((1,), ("pod",))
    return jax.jit(shard_map(
        lambda xx, ee: jcoll.compressed_psum(xx, "pod", ee), mesh=mesh,
        in_specs=(PartitionSpec(), PartitionSpec()),
        out_specs=(PartitionSpec(), PartitionSpec()), check_rep=False))


@pytest.fixture(scope="module")
def world_of_one():
    """A (data, model) = (1, 1) gloo mesh in this process, destroyed after
    the module's tests."""
    if dist.is_initialized():
        pytest.fail("a process group is already running in this process")
    mesh = make_debug_mesh(device_type="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def test_debug_mesh_of_one_rank(world_of_one):
    assert world_of_one.mesh_dim_names == ("data", "model")
    assert tuple(world_of_one.shape) == (1, 1)
    assert mesh_chip_count(world_of_one) == 1
    assert mesh_chip_count(SimpleNamespace(shape=MESHES["pod2"])) == 512
    with pytest.raises(ValueError):
        make_debug_mesh(model=2, device_type="cpu")
    for multi_pod in (False, True):
        with pytest.raises(RuntimeError, match="ranks"):
            make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def test_compressed_psum_at_one_rank_equals_jax(world_of_one):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(256) * 0.01).astype(np.float32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    terr, jerr = torch.zeros_like(tx), jnp.zeros_like(jx)
    acc = torch.zeros_like(tx)
    with use_sharding(world_of_one):
        for _ in range(20):
            red, terr = tcoll.compressed_psum(tx, "data", terr)
            jred, jerr = _jax_psum()(jx, jerr)
            np.testing.assert_array_equal(red.numpy(), np.asarray(jred))
            np.testing.assert_array_equal(terr.numpy(), np.asarray(jerr))
            acc = acc + red
    # error feedback keeps the accumulated error ~one quantization step
    q_step = float(tx.abs().max()) / 127.0
    assert float((acc - tx * 20).abs().max()) < 3 * q_step


def test_grad_sync_tree_uncompressed_exact(world_of_one):
    g = {"a": torch.arange(4, dtype=torch.float32),
         "b": {"c": torch.ones((2, 2))}}
    group = world_of_one.get_group("data")
    out, err = tcoll.grad_sync_tree(g, group, compress=False)
    torch.testing.assert_close(out["a"], g["a"], rtol=0, atol=0)
    torch.testing.assert_close(out["b"]["c"], g["b"]["c"], rtol=0, atol=0)
    assert float(err["a"].abs().sum()) == 0.0
    red, err = tcoll.grad_sync_tree(g, group)
    assert set(red) == {"a", "b"} and set(err["b"]) == {"c"}
    with pytest.raises(RuntimeError, match="outside a mesh"):
        tcoll.compressed_psum(g["a"], "data")


def test_footprint_home_survives_reset():
    fp = tsh.operand_footprint(4e6, shard_index=3, n_clusters=2)
    assert fp.home == 1 and fp.resident == 1 and fp.sticky is False
    lt = LocalityTracker(hikey960())
    lt.place("matmul", fp, 0)
    assert fp.resident == 0
    fp.reset()
    assert fp.resident == 1
    kv = DataFootprint(nbytes=1e6)
    kv.resident = 1
    kv.reset()
    assert kv.resident == -1
    with pytest.raises(ValueError):
        tsh.operand_footprint(1.0, 0, 0)


# ------------------------------------------------------- 4 gloo ranks
PSUM_N = 300


def _psum_inputs(rank: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(100 + rank)
    return ((rng.standard_normal(PSUM_N) * 0.01).astype(np.float32),
            (rng.standard_normal(PSUM_N) * 1e-4).astype(np.float32))


def _rank_main(rank: int, store_path: str, out_dir: str) -> None:
    """One of 4 gloo ranks: writes what it holds to ``out_dir``."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.parallel.sharding import abstract_tensor

    dist.init_process_group("gloo", store=dist.FileStore(store_path, 4),
                            rank=rank, world_size=4)
    try:
        res = {}
        x, e = _psum_inputs(rank)
        line = DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("pod",))
        with use_sharding(line):
            red, err = tcoll.compressed_psum(torch.from_numpy(x), "pod",
                                             torch.from_numpy(e))
        np.save(Path(out_dir) / f"red{rank}.npy", red.numpy())
        np.save(Path(out_dir) / f"err{rank}.npy", err.numpy())

        mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                          mesh_dim_names=("data", "model"))
        coord = mesh.get_coordinate()
        model = get_model(tconfigs.get_smoke_config("llama3.2-1b"))
        with use_sharding(mesh):
            res["params"] = {n: list(v.to_local().shape)
                             for n, v in model.abstract_params().items()}
            cache = model.init_cache(4, 16, device="meta")
            res["cache_k"] = list(cache["k"].to_local().shape)
            res["cache_pos"] = [cache["pos"].device.type,
                                list(cache["pos"].shape)]
            # constrain a replicated tensor to each layout: the rows this
            # rank keeps, under both rule tables
            full = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
            rep = DTensor.from_local(full, mesh, [Replicate(), Replicate()])
            res["rows"] = {}
            for rules in sorted(RULES):
                tsh.set_rules({**LOGICAL_RULES, **RULES[rules]})
                for name in ("batch", "ff", "kv_seq"):
                    got = tsh.constrain(rep, name, None)
                    res["rows"][f"{rules}:{name}"] = \
                        got.to_local()[:, 0].div(3).int().tolist()
                    # and an abstract tensor of the same names
                    sh = tsh.logical_sharding((8, 3), (name, None))
                    res["rows"][f"{rules}:{name}:meta"] = list(
                        abstract_tensor((8, 3), torch.float32,
                                        sh).to_local().shape)
            tsh.set_rules(LOGICAL_RULES)
            assert tsh.constrain(full, "batch", None) is full
        fp = tsh.operand_footprint(4e6, shard_index=rank, n_clusters=2)
        res["footprint"] = [fp.home, fp.resident, fp.sticky]
        res["coord"] = list(coord)
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo4")
    mp.spawn(_rank_main, args=(str(tmp / "store"), str(tmp)), nprocs=4,
             join=True)
    return tmp


def _jax_chunk_rows(spec_entry, coord: dict, sizes: dict, rows: int):
    """The rows JAX gives a device at ``coord`` for a dim sharded over
    ``spec_entry`` (major to minor)."""
    axes = () if spec_entry is None else (
        (spec_entry,) if isinstance(spec_entry, str) else spec_entry)
    idx, n = 0, 1
    for ax in axes:
        idx = idx * sizes[ax] + coord[ax]
        n *= sizes[ax]
    per = rows // n
    return list(range(idx * per, (idx + 1) * per))


def test_four_ranks_compressed_psum_equals_jax(four_ranks):
    wires, errs = [], []
    for rank in range(4):
        x, e = _psum_inputs(rank)
        jred, jerr = _jax_psum()(jnp.asarray(x), jnp.asarray(e))
        wires.append(np.asarray(jred, np.float64))   # one rank: its wire
        errs.append(np.asarray(jerr))
    want = np.mean(wires, axis=0)
    slack = 4 * 2.0 ** -24 * np.sum(np.abs(wires), axis=0)
    for rank in range(4):
        got = np.load(four_ranks / f"red{rank}.npy").astype(np.float64)
        assert np.all(np.abs(got - want) <= 1e-6 * np.abs(want) + slack)
        assert np.load(four_ranks / f"err{rank}.npy").tobytes() == \
            errs[rank].tobytes()


def _local_shape(shape, names, ctx) -> list:
    """The shape of one device's shard under ``logical_spec``."""
    spec = tuple(logical_spec(shape, names, ctx))
    spec += (None,) * (len(shape) - len(spec))
    out = []
    for n, e in zip(shape, spec):
        axes = () if e is None else ((e,) if isinstance(e, str) else e)
        out.append(n // int(np.prod([ctx.axis_size(a) for a in axes])))
    return out


def test_four_ranks_local_shards_follow_logical_spec(four_ranks):
    sizes = {"data": 2, "model": 2}
    ctx = ShardingCtx(SimpleNamespace(shape=sizes), dict(LOGICAL_RULES))
    model = get_model(tconfigs.get_smoke_config("llama3.2-1b"))
    cfg = model.cfg
    kv = ((cfg.n_layers, 4, cfg.n_kv_heads, 16, cfg.hd),
          ("layers", "batch", "kv_heads", "kv_seq", None))
    for rank in range(4):
        res = json.loads((four_ranks / f"rank{rank}.json").read_text())
        coord = dict(zip(("data", "model"), res["coord"]))
        for name, d in model.param_defs().items():
            assert res["params"][name] == \
                _local_shape(d.shape, d.names, ctx), name
        assert res["cache_k"] == _local_shape(*kv, ctx)
        assert res["cache_k"] != list(kv[0])
        assert res["cache_pos"] == ["meta", []]
        for rules in sorted(RULES):
            rctx = ShardingCtx(SimpleNamespace(shape=sizes),
                               {**LOGICAL_RULES, **RULES[rules]})
            for name in ("batch", "ff", "kv_seq"):
                spec = logical_spec((8, 3), (name, None), rctx)
                rows = _jax_chunk_rows(spec[0] if spec else None, coord,
                                       sizes, 8)
                assert res["rows"][f"{rules}:{name}"] == rows, (rules, name)
                assert res["rows"][f"{rules}:{name}:meta"] == [len(rows), 3]
        assert res["footprint"] == [rank % 2, rank % 2, False]


# ----------------------------------------------------------- example twins
def _reference_example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(fn) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue()


def test_quickstart_twin_prints_the_reference_table():
    got = _printed(quickstart.main)
    assert got == _printed(_reference_example("quickstart").main)
    assert got.count("TAOs/s") == 15


@pytest.mark.parametrize("demo", [
    "trace_driven_demo", "poisson_stream_demo", "admission_control_demo",
    "preemption_demo", "impl_variant_demo"])
def test_multi_tenant_twin_prints_the_reference_tables(demo):
    got = _printed(getattr(multi_tenant, demo))
    assert got == _printed(getattr(_reference_example("multi_tenant"), demo))
    assert got.strip()


def test_multi_tenant_threaded_demo_completes():
    assert "completed=64" in _printed(multi_tenant.threaded_vehicle_demo)
