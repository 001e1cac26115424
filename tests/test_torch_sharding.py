"""The port's partition rules against the JAX package's, and the port on a
device mesh: every rule's spec, as a tuple, for every registry config on
the (4, 4) and (2, 2, 4) meshes (the cases of ``tests/test_sharding.py``),
the specs as DTensor placements (a dim split over two axes in the
reference's major-first order), the one-rank mesh (the train and serve
steps give ``train_step_fn``'s and ``decode_step``'s bits, the sharded
matvec the unsharded one's), and one 2-process gloo group: the sharded
matvec against the unsharded one, and the world-size-2 train step
against the world-size-1 step.

Tolerances: specs exactly; the sharded matvec within 1e-6 relative of
the unsharded pack's (the same rows in the same order) and 2e-4 of the
dense pruned product (the reference's own bound); the world-size-2 step
within 5e-5 of each leaf's max|.| after two steps, the reference's bound
for microbatch accumulation, which reorders the same float32 sums (two
half-batch means averaged in place of one mean; here it reads 1.3e-5,
with the loss equal and the grad norm within 2e-7), and the losses and
grad norms within 1e-5 relative."""
import json
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import SHAPES  # noqa: E402
from repro.configs.registry import REGISTRY  # noqa: E402
from repro.configs.registry import get_config as ref_config  # noqa: E402
from repro.core.sparse_model import sparsify_model as ref_sparsify  # noqa
from repro.launch import specs as S  # noqa: E402
from repro.models import factory as RF  # noqa: E402
from repro.sharding import partition as RP  # noqa: E402

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.sparse_model import sparsify_model  # noqa: E402
from repro_torch.models import factory as PF  # noqa: E402
from repro_torch.sharding import partition as PP  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = sorted(REGISTRY)
MESHES = {"4x4": ((4, 4), ("data", "model")),
          "2x2x4": ((2, 2, 4), ("pod", "data", "model"))}


def _jax_mesh(shape, axes):
    # an abstract stand-in is enough for spec derivation
    n = int(np.prod(shape))
    devs = np.array(jax.devices() * n)[:n]
    return jax.sharding.Mesh(devs.reshape(shape), axes)


def _meshes(name):
    shape, axes = MESHES[name]
    return _jax_mesh(shape, axes), PP.MeshShape(tuple(zip(axes, shape)))


def _ref_specs(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(spec) for path, spec in flat}


def _port_specs(tree) -> dict:
    return dict(flatten(tree))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_rules_match_reference(arch, mesh_name):
    """Train (FSDP + TP), serve, and single-stream serve specs of the
    port's own params tree (on the meta device) against the reference's
    of its eval_shape tree."""
    jmesh, mesh = _meshes(mesh_name)
    ref_shapes = S.params_specs(ref_config(arch))
    port_shapes = PF.init_params(get_config(arch), device="meta")
    assert ({k: tuple(v.shape) for k, v in flatten(port_shapes)}
            == {k: tuple(v.shape) for k, v in flatten(ref_shapes)})
    cases = [
        (RP.param_pspecs(ref_shapes, jmesh),
         PP.param_pspecs(port_shapes, mesh)),
        (RP.serve_param_pspecs(ref_shapes, jmesh),
         PP.serve_param_pspecs(port_shapes, mesh)),
        (RP.serve_param_pspecs(ref_shapes, jmesh, global_batch=1),
         PP.serve_param_pspecs(port_shapes, mesh, global_batch=1)),
    ]
    for want, got in cases:
        assert _port_specs(got) == _ref_specs(want)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_rules_match_reference(arch, mesh_name):
    jmesh, mesh = _meshes(mesh_name)
    cfg = ref_config(arch)
    trees = [S.train_batch_specs(cfg, SHAPES["train_4k"]),
             S.decode_batch_specs(cfg, SHAPES["decode_32k"]),
             S.decode_batch_specs(cfg, SHAPES["long_500k"])]
    for tree in trees:
        assert (_port_specs(PP.batch_pspecs(tree, mesh))
                == _ref_specs(RP.batch_pspecs(tree, jmesh)))
    for shape in ("decode_32k", "long_500k"):
        cache = S.cache_specs(cfg, SHAPES[shape])
        assert (_port_specs(PP.cache_pspecs(cache, mesh))
                == _ref_specs(RP.cache_pspecs(cache, jmesh)))
    # an int8 KV cache's scale leaves
    cache8 = S.cache_specs(cfg.replace(kv_cache_dtype="int8"),
                           SHAPES["decode_32k"])
    assert (_port_specs(PP.cache_pspecs(cache8, mesh))
            == _ref_specs(RP.cache_pspecs(cache8, jmesh)))
    # block-pool arenas (Lx, blocks, block, KV[, hd]) and small leaves
    pages = {"k": jax.ShapeDtypeStruct((cfg.n_layers, 64, 16,
                                        cfg.n_kv_heads, cfg.hd), np.float32),
             "k_scale": jax.ShapeDtypeStruct((cfg.n_layers, 6, 16,
                                              cfg.n_kv_heads), np.float32),
             "table": jax.ShapeDtypeStruct((8, 4), np.int32)}
    assert (_port_specs(PP.paged_cache_pspecs(pages, mesh))
            == _ref_specs(RP.paged_cache_pspecs(pages, jmesh)))


@pytest.mark.parametrize("quant", [None, "int8"])
def test_sparse_pack_rules_match_reference(quant):
    """The port's ``sparsify_model`` dict and the reference's, from the
    same params, give the same spec per bucket plane."""
    jmesh, mesh = _meshes("4x4")
    cfg = ref_config("llama7b-espim", reduced=True)
    pcfg = get_config("llama7b-espim", reduced=True)
    params = RF.init_params(cfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    projections = "all" if quant is None else "mlp"
    want = RP.sparse_pack_pspecs(
        ref_sparsify(cfg, params, 0.9, projections=projections,
                     row_tile=32, quant=quant), jmesh)
    got = PP.sparse_pack_pspecs(
        sparsify_model(pcfg, tparams, 0.9, projections=projections,
                       row_tile=32, quant=quant, device="cpu"), mesh)
    assert _port_specs(got) == _ref_specs(want)
    keys = {k.rsplit("/", 1)[-1] for k in _port_specs(got)}
    assert ({"q", "srow"} <= keys) == (quant == "int8")


def test_mesh_shape_and_axes():
    mesh = PP.MeshShape.of(pod=2, data=2, model=4)
    assert mesh.axis_names == ("pod", "data", "model")
    assert PP.batch_axes(mesh) == ("pod", "data")
    assert PP.mesh_axis_size(mesh, ("pod", "data")) == 4
    assert PP.mesh_axis_size(mesh, None) == 1
    assert PP.batch_axes(PP.MeshShape.of(data=4, model=4)) == ("data",)


def test_named_maps_specs_to_placements():
    """One placement per mesh dim; a dim over ("pod", "data") splits pod
    major, data minor, the reference's order (JAX: index = pod x |data|
    + data), which DTensor gives when the shards are listed in mesh
    order; names out of mesh order raise."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        _compute_local_shape_and_global_offset as local_offset

    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert PP.named(mesh, (None, "model")) == [Replicate(), Replicate(),
                                               Shard(1)]
    assert PP.named(mesh, ()) == [Replicate()] * 3
    pl = PP.named(mesh, (("pod", "data"), "model"))
    assert pl == [Shard(0), Shard(0), Shard(1)]
    tree = PP.named(mesh, {"a": (None,), "b": [("data",)]})
    assert tree == {"a": [Replicate()] * 3,
                    "b": [[Replicate(), Shard(0), Replicate()]]}
    for pod in range(2):
        for data in range(2):
            for model in range(4):
                shape, off = local_offset((16, 8), (2, 2, 4),
                                          [pod, data, model], pl)
                assert shape == (4, 2)
                assert off == ((pod * 2 + data) * 4, model * 2)
    with pytest.raises(ValueError, match="mesh order"):
        PP.named(mesh, (("data", "pod"),))


def test_shard_hint_is_the_identity():
    from repro_torch.models import layers as L
    x = torch.ones(2, 3)
    assert L.shard_hint(x, "batch", "model") is x


def test_production_mesh_needs_its_ranks():
    from repro_torch.launch.mesh import make_production_mesh
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="needs 512 ranks"):
        make_production_mesh(multi_pod=True, device="cpu")


def test_one_rank_mesh_steps_give_the_plain_bits():
    """On the (1, 1) mesh: ``make_train_step`` against ``train_step_fn``
    for two steps (compression on), ``make_serve_step`` against
    ``factory.decode_step``, ``espim_matvec_sharded`` against the
    unsharded pack, all in bits; ``donate=False`` leaves the caller's
    state untouched."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.espim_linear import (ESPIMLinear,
                                               espim_matvec_sharded,
                                               make_sharded_weights)
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.serve.serve_step import make_serve_step
    from repro_torch.train import train_step as ts

    mesh = make_local_mesh(device="cpu")
    cfg = get_config("granite-3-2b", reduced=True).replace(n_layers=2)
    ocfg = OptConfig(warmup_steps=2, decay_steps=20, peak_lr=1e-3)
    pipe = SyntheticPipeline.for_model(cfg, ShapeConfig("t", 16, 4, "train"),
                                       device="cpu")

    def state():
        return ts.init_train_state(cfg, ocfg,
                                   torch.Generator().manual_seed(0),
                                   compress_grads=True, device="cpu")

    plain = state()
    step, pspecs, bspecs = ts.make_train_step(
        cfg, ocfg, mesh, ts.init_train_state(cfg, ocfg, compress_grads=True,
                                             device="meta"),
        pipe.batch_at(0), compress_grads=True)
    placed = PP.logical_to_sharding(state(), pspecs, mesh)
    for i in range(2):
        placed, m1 = step(placed, PP.logical_to_sharding(pipe.batch_at(i),
                                                         bspecs, mesh))
        plain, m2 = ts.train_step_fn(cfg, ocfg, plain, pipe.batch_at(i),
                                     compress_grads=True)
        assert torch.equal(m1["loss"], m2["loss"])
    for (name, a), (_, b) in zip(flatten(placed), flatten(plain)):
        assert torch.equal(PP.full_value(a), b), name
    step2, _, _ = ts.make_train_step(
        cfg, ocfg, mesh, ts.init_train_state(cfg, ocfg, compress_grads=True,
                                             device="meta"),
        pipe.batch_at(0), compress_grads=True, donate=False)
    before = {k: PP.full_value(v).clone() for k, v in flatten(placed)}
    out, _ = step2(placed, PP.logical_to_sharding(pipe.batch_at(2), bspecs,
                                                  mesh))
    assert all(torch.equal(PP.full_value(v), before[k])
               for k, v in flatten(placed))
    assert not torch.equal(PP.full_value(out["params"]["embed"]),
                           before["params/embed"])

    params = plain["params"]
    cache = PF.init_cache(cfg, 2, 8, device="cpu")
    batch = {"tokens": torch.tensor([[3], [7]], dtype=torch.int32)}
    sstep, sp, cs, bs = make_serve_step(cfg, mesh, params, cache, batch)
    nxt, logits, new = sstep(PP.logical_to_sharding(params, sp, mesh),
                             PP.logical_to_sharding(cache, cs, mesh),
                             PP.logical_to_sharding(batch, bs, mesh))
    want, want_cache = PF.decode_step(cfg, params, cache, batch)
    assert torch.equal(logits, want)
    assert torch.equal(nxt[:, 0], torch.argmax(want[:, -1], -1).int())
    for name, t in flatten(want_cache):
        assert torch.equal(PP.full_value(dict(flatten(new))[name]), t)

    rng = np.random.default_rng(2)
    w = rng.standard_normal((384, 256)).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal(256).astype(np.float32))
    sh = make_sharded_weights(w, 1, prune_sparsity=0.85, chunk_cols=128)
    y = espim_matvec_sharded(sh, x, mesh)
    lin = ESPIMLinear.from_dense(w, prune_sparsity=0.85, chunk_cols=128,
                                 device="cpu")
    assert torch.equal(y, lin(x))


_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    rank, store_path, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 2),
                            rank=rank, world_size=2)
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core.espim_linear import (espim_matvec_sharded,
                                               make_sharded_weights)
    from repro_torch.core.pruning import magnitude_prune
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.sharding import partition as PP
    from repro_torch.train import train_step as ts
    from repro_torch.tree import flatten

    res = {}
    banks = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
    rng = np.random.default_rng(2)
    w = rng.standard_normal((384, 256)).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal(256).astype(np.float32))
    y = espim_matvec_sharded(make_sharded_weights(w, 2, prune_sparsity=0.85,
                                                  chunk_cols=128), x, banks)
    one = make_sharded_weights(w, 1, prune_sparsity=0.85, chunk_cols=128)
    y1 = kref.scatter_rows_ref(
        ops.espim_spmv(torch.from_numpy(one["values"][0]),
                       torch.from_numpy(one["cols"][0]), x,
                       chunk_cols=one["chunk_cols"]),
        torch.from_numpy(one["perm"][0]), one["n_rows"])
    dense = torch.from_numpy(magnitude_prune(w, 0.85)) @ x
    res["matvec_vs_one_bank"] = float((y - y1).abs().max() / y1.abs().max())
    res["matvec_vs_dense"] = float((y - dense).abs().max())

    mesh = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data", "model"))
    cfg = get_config("granite-3-2b", reduced=True).replace(n_layers=2)
    ocfg = OptConfig(warmup_steps=2, decay_steps=20, peak_lr=1e-3)
    pipe = SyntheticPipeline.for_model(cfg, ShapeConfig("t", 16, 4, "train"),
                                       device="cpu")

    def state():
        return ts.init_train_state(cfg, ocfg,
                                   torch.Generator().manual_seed(0),
                                   device="cpu")

    step, pspecs, bspecs = ts.make_train_step(
        cfg, ocfg, mesh, ts.init_train_state(cfg, ocfg, device="meta"),
        pipe.batch_at(0))
    placed = PP.logical_to_sharding(state(), pspecs, mesh)
    res["sharded_leaves"] = sum(
        tuple(t.to_local().shape) != tuple(t.shape)
        for _, t in flatten(placed))
    plain = state()
    for i in range(2):
        placed, m = step(placed, PP.logical_to_sharding(pipe.batch_at(i),
                                                        bspecs, mesh))
        plain, m1 = ts.train_step_fn(cfg, ocfg, plain, pipe.batch_at(i))
    res["loss"] = [float(m["loss"]), float(m1["loss"])]
    res["grad_norm"] = [float(m["grad_norm"]), float(m1["grad_norm"])]
    errs = {}
    for (name, a), (_, b) in zip(flatten(placed), flatten(plain)):
        full = PP.full_value(a).float()
        errs[name] = float((full - b.float()).abs().max()
                           / max(float(b.float().abs().max()), 1e-12))
    res["leaf_err"] = errs
    json.dump(res, open(out, "w"))
    dist.destroy_process_group()
""")


def test_two_rank_gloo_group(tmp_path):
    """Two processes on a FileStore: the sharded matvec (one bank each)
    against one bank and the dense product, and the (data = 2) train
    step against the world-size-1 step on the same global batch."""
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    store = tmp_path / "store"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r),
                               str(store), str(tmp_path / f"r{r}.json")],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), logs
    for r in range(2):
        res = json.loads((tmp_path / f"r{r}.json").read_text())
        assert res["matvec_vs_one_bank"] <= 1e-6
        assert res["matvec_vs_dense"] <= 2e-4
        assert res["sharded_leaves"] > 0           # FSDP over data = 2
        a, b = res["loss"]
        assert abs(a - b) <= 1e-5 * abs(b)
        a, b = res["grad_norm"]
        assert abs(a - b) <= 1e-5 * abs(b)
        bad = {k: v for k, v in res["leaf_err"].items() if v > 5e-5}
        assert not bad, bad
