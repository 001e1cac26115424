"""The port's dry run (``repro_torch.launch.{specs, dryrun}``) against the
JAX package's:

* ``specs.input_specs`` gives the leaves of the reference's
  ``jax.eval_shape`` stand-ins (names, shapes, dtypes) for every assigned
  arch and shape;
* for every assigned arch and shape on both production meshes (16 x 16
  and 2 x 16 x 16, fake groups of 256 and 512 ranks), the dry run's
  per-device ``argument_size_in_bytes`` equals the sum of the local shard
  bytes under the reference's partition specs (inputs placed only, no
  step);
* ``run_cell`` traces train, prefill and decode on reduced configs of
  all six families on fake (2, 2) and (2, 2, 2) groups: ``status`` ok,
  positive FLOPs, the reference's record keys.

A process holds one default process group, so the port's side runs in
subprocesses (one per check, started together)."""
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import SHAPES  # noqa: E402
from repro.configs.registry import ASSIGNED, cells  # noqa: E402
from repro.configs.registry import get_config as ref_config  # noqa: E402
from repro.launch import specs as RS  # noqa: E402
from repro.sharding import partition as RP  # noqa: E402
from repro.train import train_step as RT  # noqa: E402

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import specs as PS  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CELLS = [(a, s) for a, s, _ in cells()]
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
FAMILY_ARCHS = ("granite-3-2b", "phi3.5-moe-42b-a6.6b", "qwen2-vl-2b",
                "whisper-small", "rwkv6-1.6b", "zamba2-2.7b")
SMALL_MESHES = ((2, 2), (2, 2, 2))
SMALL_KINDS = ("train", "prefill", "decode")
# production cells traced whole (arch, shape, mesh)
PRODUCTION_CELLS = (("granite-3-2b", "decode_32k", "single"),)
# granite-3-2b x decode_32k on 16 x 16 per device when the decode step
# gathered every layer's weights (the dry run of the tree before the
# tensor-parallel products): all-gather operand bytes, dot FLOPs, peak
GATHERED_DECODE_32K = {"all-gather": 0.334e9, "dot_flops": 4.59e10,
                       "peak": 1.17e9}
RECORD_KEYS = {"arch", "shape", "mesh", "mesh_shape", "n_devices", "status",
               "trace_s", "hlo_cost", "memory", "fits_card"}

_PORT = textwrap.dedent("""
    import json, sys
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun

    mode, out = sys.argv[1], sys.argv[2]
    cells = json.loads(sys.argv[3])
    res = {}
    small = {"train": ShapeConfig("t", 32, 8, "train"),
             "prefill": ShapeConfig("p", 32, 4, "prefill"),
             "decode": ShapeConfig("d", 64, 8, "decode")}
    for c in cells:
        if mode == "cell":
            r = dryrun.run_cell(c[0], c[1], c[2] == "multi", verbose=False)
            res["|".join(["cell"] + c)] = r
        elif mode == "inputs":
            arch, shape, mesh = c
            r = dryrun.run_cell(arch, shape, mesh == "multi",
                                inputs_only=True, verbose=False)
            res["|".join(c)] = r["memory"]["argument_size_in_bytes"]
        else:
            arch, kind, mesh = c
            r = dryrun.run_cell(arch, kind, False, verbose=False,
                                reduced=True, mesh_shape=tuple(mesh),
                                shape=small[kind])
            res["|".join([arch, kind, str(mesh)])] = r
    json.dump(res, open(out, "w"))
""")


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The port's records: per-device argument bytes of every production
    cell, and the small cells' records."""
    tmp = tmp_path_factory.mktemp("dryrun")
    jobs = {"inputs": [[a, s, m] for a, s in CELLS for m in MESHES],
            "cell": [list(c) for c in PRODUCTION_CELLS]}
    for mesh in SMALL_MESHES:
        jobs[f"small{len(mesh)}"] = [[a, k, list(mesh)] for a in FAMILY_ARCHS
                                     for k in SMALL_KINDS]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", _PORT, name if name in ("inputs", "cell")
         else "small", str(tmp / f"{name}.json"), json.dumps(cs)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, cs in jobs.items()}
    try:
        logs = {n: p.communicate(timeout=600)[0] for n, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    out = {}
    for name, p in procs.items():
        assert p.returncode == 0, logs[name][-4000:]
        out.update(json.loads((tmp / f"{name}.json").read_text()))
    return out


def _ref_leaves(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): (tuple(x.shape), np.dtype(x.dtype).name)
            for path, x in flat}


def _port_leaves(tree) -> dict:
    return {k: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for k, x in flatten(tree)}


@pytest.mark.parametrize("arch", ASSIGNED)
def test_input_specs_match_reference(arch):
    for shape_name in SHAPES:
        shape = SHAPES[shape_name]
        want = _ref_leaves(RS.input_specs(ref_config(arch), shape))
        got = _port_leaves(PS.input_specs(get_config(arch), shape))
        assert got == want, shape_name
        assert all(x.device.type == "meta" for _, x in flatten(
            PS.input_specs(get_config(arch), shape)))


def _jax_mesh(shape, axes):
    # an abstract stand-in is enough for spec derivation
    n = int(np.prod(shape))
    devs = np.array(jax.devices() * n)[:n]
    return jax.sharding.Mesh(devs.reshape(shape), axes)


def _ref_arg_bytes(arch: str, shape_name: str, mesh_name: str) -> int:
    """Sum over the cell's inputs of each leaf's local shard bytes under
    the reference dry run's in_shardings."""
    cfg, shape = ref_config(arch), SHAPES[shape_name]
    if shape.kind == "decode" and cfg.family != "ssm":
        cfg = cfg.replace(kv_cache_dtype="int8")
    mesh = _jax_mesh(*MESHES[mesh_name])
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    sp = RS.input_specs(cfg, shape)
    if shape.kind == "train":
        trees = [(sp["state"], RT.param_state_pspecs(sp["state"], mesh)),
                 (sp["batch"], RP.batch_pspecs(sp["batch"], mesh))]
    elif shape.kind == "prefill":
        trees = [(sp["params"], RP.param_pspecs(sp["params"], mesh)),
                 (sp["batch"], RP.batch_pspecs(sp["batch"], mesh))]
    else:
        trees = [(sp["params"], RP.serve_param_pspecs(
                      sp["params"], mesh, global_batch=shape.global_batch)),
                 (sp["cache"], RP.cache_pspecs(sp["cache"], mesh)),
                 (sp["batch"], RP.batch_pspecs(sp["batch"], mesh))]
    total = 0
    for tree, specs in trees:
        leaves = jax.tree.leaves(tree)
        pspecs = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))
        assert len(leaves) == len(pspecs)
        for x, spec in zip(leaves, pspecs):
            n = 1
            for d, dim in enumerate(x.shape):
                axis = spec[d] if d < len(spec) else None
                names = () if axis is None else (
                    (axis,) if isinstance(axis, str) else tuple(axis))
                div = math.prod(sizes[a] for a in names)
                assert dim % div == 0
                n *= dim // div
            total += n * np.dtype(x.dtype).itemsize
    return total


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_argument_bytes_match_reference_partition(port, arch, mesh_name):
    shapes = [s for a, s in CELLS if a == arch]
    assert shapes
    for shape_name in shapes:
        got = port["|".join([arch, shape_name, mesh_name])]
        assert got == _ref_arg_bytes(arch, shape_name, mesh_name), shape_name


@pytest.mark.parametrize("mesh", SMALL_MESHES, ids=lambda m: "x".join(
    map(str, m)))
@pytest.mark.parametrize("kind", SMALL_KINDS)
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_small_cells_trace(port, arch, kind, mesh):
    rec = port["|".join([arch, kind, str(list(mesh))])]
    assert RECORD_KEYS <= set(rec)
    assert rec["status"] == "ok"
    assert rec["n_devices"] == math.prod(mesh)
    cost = rec["hlo_cost"]
    assert cost["flops"] > 0 and cost["dot_flops"] > 0
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] > 0
    assert mem["temp_size_in_bytes"] >= 0
    assert mem["output_size_in_bytes"] > 0
    # every rank gathers activations (decode) or its params' shards
    assert cost["collective_counts"]["all-gather"] > 0
    if kind == "train":       # the grads' mean over the data axes
        assert cost["collective_counts"]["all-reduce"] > 0


def test_decode_step_streams_only_weight_shards(port):
    """granite-3-2b x decode_32k on 16 x 16, per device: the decode step
    as tensor-parallel products moves activations only (all-gather bytes
    at most 5% of the step that gathered every layer's weights), each
    rank multiplies its weight shards only (dot FLOPs at most a quarter;
    attention over the local cache shard sets the floor), peaks no
    higher and fits the card."""
    rec = port["|".join(("cell",) + PRODUCTION_CELLS[0])]
    assert rec["status"] == "ok"
    cost = rec["hlo_cost"]
    assert (cost["collective_bytes"]["all-gather"]
            <= 0.05 * GATHERED_DECODE_32K["all-gather"]), cost
    assert cost["dot_flops"] <= 0.25 * GATHERED_DECODE_32K["dot_flops"]
    assert (rec["memory"]["peak_size_in_bytes"]
            <= GATHERED_DECODE_32K["peak"]), rec["memory"]
    assert rec["fits_card"]


_SHARDED_VS_GATHERED = textwrap.dedent("""
    import json, sys
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.models import factory

    out, arch = sys.argv[1], sys.argv[2]
    small = {"train": ShapeConfig("t", 32, 8, "train"),
             "decode": ShapeConfig("d", 64, 8, "decode")}
    res = {}
    for path in ("sharded", "gathered"):
        # the gathered path: every family's steps gather their params
        if path == "gathered":
            factory.shards = lambda cfg, mesh: False
        for kind, shape in small.items():
            r = dryrun.run_cell(arch, kind, False, verbose=False,
                                reduced=True, mesh_shape=(4, 4), shape=shape)
            res[f"{kind}|{path}"] = r
    json.dump(res, open(out, "w"))
""")
PEAK_ARCHS = ("granite-3-2b", "phi3.5-moe-42b-a6.6b", "qwen2-vl-2b",
              "zamba2-2.7b", "whisper-small", "rwkv6-1.6b")


def _state_bytes(kind: str, shape,
                 arch: str = "granite-3-2b") -> tuple[int, int]:
    """(full, per-device) bytes of reduced ``arch``'s state at ``shape`` on
    a 4 x 4 mesh: the train state, or the decode step's params and int8
    cache, each leaf's shard under the port's partition rules."""
    from repro_torch.launch import specs as S
    from repro_torch.sharding import partition as PP
    from repro_torch.train import train_step as TS

    cfg = get_config(arch, reduced=True)
    mesh = PP.MeshShape.of(data=4, model=4)
    if kind == "train":
        tree = S.state_specs(cfg)
        specs = TS.param_state_pspecs(tree, mesh)
    else:
        cfg = cfg.replace(kv_cache_dtype="int8")
        params, cache = S.params_specs(cfg), S.cache_specs(cfg, shape)
        tree = [params, cache]
        specs = [PP.serve_param_pspecs(params, mesh,
                                       global_batch=shape.global_batch),
                 PP.cache_pspecs(cache, mesh)]
    full = local = 0
    flat_s = dict(flatten(specs))
    for path, x in flatten(tree):
        n = x.numel() * x.element_size()
        full += n
        local += n // PP.mesh_axis_size(mesh, tuple(
            a for axis in flat_s[path] for a in PP.axis_names(axis)))
    return full, local


@pytest.fixture(scope="module")
def sharded_vs_gathered_all(tmp_path_factory):
    """Each arch of ``PEAK_ARCHS`` in a process of its own, all started
    together: {arch: {"kind|path": record}}."""
    tmp = tmp_path_factory.mktemp("dryrun_sharded")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = {a: subprocess.Popen(
        [sys.executable, "-c", _SHARDED_VS_GATHERED, str(tmp / f"{a}.json"),
         a], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for a in PEAK_ARCHS}
    try:
        logs = {a: p.communicate(timeout=600)[0] for a, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for a, p in procs.items():
        assert p.returncode == 0, logs[a][-4000:]
    return {a: json.loads((tmp / f"{a}.json").read_text())
            for a in PEAK_ARCHS}


@pytest.fixture(scope="module")
def sharded_vs_gathered(sharded_vs_gathered_all):
    return sharded_vs_gathered_all["granite-3-2b"]


@pytest.mark.parametrize("kind", ("train", "decode"))
def test_sharded_step_peak_below_gathered(sharded_vs_gathered, kind):
    """Reduced granite on a fake 4 x 4 group: the dense family's sharded
    step (ZeRO-3 + TP, or the decode step over a cache left at its
    shards) peaks below the step that gathers its params (and cache) by
    at least the whole state less this rank's shards of it, and its
    train step reduce-scatters the grads."""
    from repro_torch.configs.base import ShapeConfig

    new = sharded_vs_gathered[f"{kind}|sharded"]
    old = sharded_vs_gathered[f"{kind}|gathered"]
    assert new["status"] == old["status"] == "ok"
    assert (new["memory"]["argument_size_in_bytes"]
            == old["memory"]["argument_size_in_bytes"])
    shape = (ShapeConfig("t", 32, 8, "train") if kind == "train"
             else ShapeConfig("d", 64, 8, "decode"))
    full, local = _state_bytes(kind, shape)
    assert full > 4 * local
    drop = (old["memory"]["peak_size_in_bytes"]
            - new["memory"]["peak_size_in_bytes"])
    assert drop >= full - local, (drop, full, local)
    counts = new["hlo_cost"]["collective_counts"]
    if kind == "train":
        assert counts["reduce-scatter"] > 0
        assert old["hlo_cost"]["collective_counts"]["reduce-scatter"] == 0


@pytest.mark.parametrize("kind", ("train", "decode"))
@pytest.mark.parametrize("arch", PEAK_ARCHS[1:])
def test_family_sharded_step_peak_below_gathered(sharded_vs_gathered_all,
                                                 arch, kind):
    """As above for reduced phi3.5-moe (experts on ``model``, each rank
    running its own; the decode group spans the data ranks), qwen2-vl
    (M-RoPE, the vision splice), zamba2 (the Mamba2 mixer's in_proj
    and conv gathered along ``model`` inside the remat unit in
    training, the SSM state at its shards in decode), whisper (the
    encoder, the cross K / V cache) and rwkv6 (the WKV state by K): the
    sharded step peaks below the gathered one by at least the whole
    state less this rank's shards of it."""
    from repro_torch.configs.base import ShapeConfig

    rec = sharded_vs_gathered_all[arch]
    new, old = rec[f"{kind}|sharded"], rec[f"{kind}|gathered"]
    assert new["status"] == old["status"] == "ok"
    shape = (ShapeConfig("t", 32, 8, "train") if kind == "train"
             else ShapeConfig("d", 64, 8, "decode"))
    full, local = _state_bytes(kind, shape, arch)
    drop = (old["memory"]["peak_size_in_bytes"]
            - new["memory"]["peak_size_in_bytes"])
    assert drop >= full - local, (drop, full, local)
    if kind == "train":
        assert new["hlo_cost"]["collective_counts"]["reduce-scatter"] > 0
