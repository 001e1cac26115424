"""The dense family's sharded train step (``train_step.make_train_step``:
ZeRO-3 on ``data``, tensor parallelism on ``model``, the sharded AdamW)
on gloo process groups, against the world-size-1 step and the JAX
reference.

One launch per mesh -- (2, 1) data only, (1, 2) model only, (2, 2), and
(2, 2, 2) with the ``pod`` axis -- runs the cases of ``CASES`` on 2, 2, 4
and 8 processes spawned as subprocesses on a ``FileStore``; each rank also runs ``train_step_fn`` on
the whole batch and compares its shards with the slices of that state.
The cases, reduced configs in float32:

  * granite: gated MLP, RMSNorm, tied embeddings (4 q / 2 KV heads: the
    heads split on ``model``);
  * nemotron: relu^2 MLP, untied ``lm_head``;
  * granite with one KV head: a model shard holds half of it, so k and v
    are all-gathered along ``model`` before attention;
  * qwen2.5 with 3 q heads: they do not divide ``model``, so attention
    runs on every head on every rank (QKV biases too);
  * at (2, 2) granite with ``microbatches=2`` and with
    ``compress_grads=True``;
  * at (2, 2, 2) (the batch over ``pod`` x ``data``, the params over
    ``data`` only) granite with one KV head and nemotron.

Held within 1e-5 relative of the world-size-1 step: the first step's
grads on the shards (max |diff| / max |ref| per leaf: 3e-7 on ``data``,
2.2e-6 with ``model``, whose products and vocab sums add in another
order), and over 3 steps the loss and the grad norm.  Every param /
master / mu / nu shard after 3 steps is held within 2e-5 in the L2 norm
of each leaf (|diff| / |ref|): the grads' float32 rounding moves the
params, and the later steps' grads at those params carry it on (AdamW
divides each by its own sqrt(nu)), so the world-size-1 step differs
from itself with ``microbatches=2`` by 2.2e-5 at single elements and
4.7e-6 in L2 after 3 steps (granite), and the sharded steps read up to
1.3e-5 in L2 (qwen2.5 with 3 heads, whose attention and vocab sums on
``model`` add in another order too).  ``bk``
is not held after the first step: softmax is invariant to a shift of
every key, so its exact gradient is zero and its Adam step normalises
rounding noise (the world-size-1 step against itself with two
microbatches: 1.5e-3).  With ``compress_grads`` a grad within rounding
of a half quantum takes the other code, so the step is held on its loss
and grad norm, and the sharded compression itself on given grads in
bits (the scale's max all-reduced over the leaf's shards).

The (2, 2) launch also runs granite with one KV head from the
reference's ``init_train_state`` and batches, held within 1e-4 of the
reference's ``train_step_fn`` on one CPU device (the elastic drill's
bound), and checks what a rank holds after a step: every leaf of the
state at its spec's shard shape (none whole that its spec splits), and
among the step's collectives a reduce-scatter (counted by
``CostMode``)."""
import json
import math
import os
import subprocess
import sys
import textwrap
from functools import partial
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import ShapeConfig as RShape  # noqa: E402
from repro.configs.registry import get_config as ref_config  # noqa: E402
from repro.data.pipeline import SyntheticPipeline as RPipe  # noqa: E402
from repro.optim.adamw import OptConfig as ROpt  # noqa: E402
from repro.train import train_step as RT  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REL_TOL = 1e-5              # against the world-size-1 step
# the state after 3 steps, L2 per leaf (module docstring): the worst
# case reads 1.31e-5 (qwen2.5 with 3 heads at (2, 2), its mu); the
# world-size-1 step against itself with two microbatches 4.7e-6 in L2
# and 2.2e-5 at single elements
STATE_L2_TOL = 2e-5
REF_REL_TOL = 1e-4          # against the JAX reference
STEPS = 3
TIMEOUT_S = 300
MESHES = ((2, 1), (1, 2), (2, 2), (2, 2, 2))
# name -> (arch, config overrides, microbatches, compress_grads)
CASES = {
    "granite": ("granite-3-2b", {}, 1, False),
    "nemotron": ("nemotron-4-15b", {}, 1, False),
    "granite_kv1": ("granite-3-2b", {"n_kv_heads": 1}, 1, False),
    "qwen_h3": ("qwen2.5-14b", {"n_heads": 3, "n_kv_heads": 1}, 1, False),
    "granite_mb2": ("granite-3-2b", {}, 2, False),
    "granite_ef": ("granite-3-2b", {}, 1, True),
}
ONLY_2X2 = ("granite_mb2", "granite_ef")
POD_CASES = ("granite_kv1", "nemotron")        # on (2, 2, 2)
REF_CASE = ("granite-3-2b", {"n_kv_heads": 1})

_WORKER = textwrap.dedent("""
    import json, sys
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    rank, world, store, data, out = (int(sys.argv[1]), int(sys.argv[2]),
                                     *sys.argv[3:6])
    shape = tuple(json.loads(sys.argv[6]))
    cases = json.loads(sys.argv[7])
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.launch.cost_analysis import CostMode
    from repro_torch.optim import compression
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.sharding import partition as PP
    from repro_torch.train import train_step as ts
    from repro_torch.tree import flatten, tree_map

    mesh = init_device_mesh("cpu", shape, mesh_dim_names=(
        ("pod", "data", "model") if len(shape) == 3 else ("data", "model")))
    ocfg = OptConfig(warmup_steps=2, decay_steps=20, peak_lr=1e-3)
    res = {}

    def max_rel(a, b):
        return float((a.double() - b.double()).abs().max()
                     / max(float(b.double().abs().max()), 1e-30))

    def l2_rel(a, b):
        return float((a.double() - b.double()).norm()
                     / max(float(b.double().norm()), 1e-30))

    def local(tree):
        return tree_map(lambda t: t.to_local(), tree)

    def vs_slices(placed, full, specs, err):
        flat_f, flat_s = dict(flatten(full)), dict(flatten(specs))
        return {p: err(getattr(t, "to_local", lambda: t)(),
                       PP.local_slice(flat_f[p], flat_s[p], mesh))
                for p, t in flatten(placed)}

    def run(cfg, state, batches, mb, ef):
        step, pspecs, bspecs = ts.make_train_step(
            cfg, ocfg, mesh, ts.init_train_state(cfg, ocfg, compress_grads=ef,
                                                 device="meta"),
            batches[0], microbatches=mb, compress_grads=ef)
        placed = PP.logical_to_sharding(tree_map(torch.clone, state),
                                        pspecs, mesh)
        metrics = []
        for i, b in enumerate(batches):
            batch = PP.logical_to_sharding(b, bspecs, mesh)
            with CostMode() as mode:
                placed, m = step(placed, batch)
            if i == 0:
                counts = mode.cost.collective_counts
            metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
        return placed, pspecs, bspecs, metrics, counts

    for name, (arch, over, mb, ef) in cases.items():
        cfg = get_config(arch, reduced=True).replace(**over)
        pipe = SyntheticPipeline.for_model(
            cfg, ShapeConfig("t", 16, 4, "train"), device="cpu")
        batches = [pipe.batch_at(i) for i in range(%(steps)d)]

        def init():
            return ts.init_train_state(cfg, ocfg,
                                       torch.Generator().manual_seed(0),
                                       compress_grads=ef, device="cpu")

        placed, pspecs, bspecs, metrics, counts = run(cfg, init(), batches,
                                                      mb, ef)
        plain, want = init(), []
        for b in batches:
            plain, m = ts.train_step_fn(cfg, ocfg, plain, b, microbatches=mb,
                                        compress_grads=ef)
            want.append({k: float(m[k]) for k in ("loss", "grad_norm")})
        flat_s = dict(flatten(pspecs))
        shapes = {p: [list(t.to_local().shape),
                      list(PP.local_slice(t, flat_s[p], mesh).shape)]
                  for p, t in flatten(placed)}
        whole = [p for p, t in flatten(placed)
                 if PP.sharded_axes(flat_s[p], mesh)
                 and t.to_local().numel() == t.numel()]
        r = {"metrics": metrics, "want": want, "shapes": shapes,
             "whole": whole, "collectives": counts,
             "sharded": sum(bool(PP.sharded_axes(s, mesh))
                            for s in flat_s.values())}
        if not ef:
            r["state_err"] = vs_slices(placed, plain, pspecs, l2_rel)
        # the first step's grads on the shards against the whole batch's
        state0 = PP.logical_to_sharding(init(), pspecs, mesh)
        layout = PP.Layout.of(state0["params"])
        b0 = PP.logical_to_sharding(batches[0], bspecs, mesh)
        _, _, g = ts._grads(cfg, local(state0["params"]), local(b0), layout)
        _, _, g1 = ts._grads(cfg, init()["params"], batches[0])
        r["grad_err"] = vs_slices(g, g1, pspecs["params"], max_rel)
        if ef:
            # the sharded compression on the shards of given grads and
            # residuals against the whole leaves'
            e1 = tree_map(lambda t: torch.randn(t.shape, generator=torch
                          .Generator().manual_seed(t.numel())) * 1e-3, g1)
            deq1, new1 = compression.ef_compress_grads(g1, e1)
            sl = lambda tree: tree_map(  # noqa: E731
                lambda t, sp: PP.local_slice(t, sp, mesh), tree,
                pspecs["params"])
            deq, new = compression.ef_compress_grads(sl(g1), sl(e1), layout)
            r["compress_equal"] = all(
                torch.equal(a, b) for (_, a), (_, b) in
                zip(flatten([deq, new]), flatten([sl(deq1), sl(new1)])))
        res[name] = r

    if data != "-":
        # the JAX reference's initial state and batches
        blob = torch.load(data, weights_only=True)
        cfg = get_config(%(ref_arch)r, reduced=True).replace(**%(ref_over)r)
        placed, _, _, metrics, _ = run(cfg, blob["state"], blob["batches"],
                                       1, False)
        full = tree_map(lambda t: PP.full_value(t).detach(), placed)
        if rank == 0:
            torch.save(full, out + ".state.pt")
        res["reference"] = {"metrics": metrics}
    if rank == 0:
        json.dump(res, open(out, "w"))
    dist.destroy_process_group()
""") % {"steps": STEPS, "ref_arch": REF_CASE[0], "ref_over": REF_CASE[1]}


def _reference():
    """The reference's initial state, batches and single-device run of
    ``REF_CASE``: (init, batches, losses, grad norms, final state) as
    numpy."""
    cfg = ref_config(REF_CASE[0], reduced=True).replace(**REF_CASE[1])
    ocfg = ROpt(warmup_steps=2, decay_steps=20, peak_lr=1e-3)
    pipe = RPipe.for_model(cfg, RShape("t", seq_len=16, global_batch=4,
                                       kind="train"))
    state = RT.init_train_state(cfg, ocfg, jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, state)
    batches = [jax.tree.map(np.asarray, pipe.batch_at(s))
               for s in range(STEPS)]
    step = jax.jit(partial(RT.train_step_fn, cfg, ocfg))
    losses, norms = [], []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return init, batches, losses, norms, jax.tree.map(np.asarray, state)


def _launch(tmp_path, shape, data) -> dict:
    world = math.prod(shape)
    tag = "x".join(map(str, shape))
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    out = tmp_path / f"{tag}.json"
    cases = {k: v for k, v in CASES.items() if _runs(shape, k)}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world),
         str(tmp_path / f"store_{tag}"), str(data), str(out),
         json.dumps(shape), json.dumps(cases)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    return {"procs": procs, "out": out}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh's launch, started together; the reference's run beside
    them."""
    from repro_torch.convert import params_from_numpy

    tmp = tmp_path_factory.mktemp("spmd_train")
    init, batches, losses, norms, final = _reference()
    data = tmp / "reference.pt"
    torch.save({"state": params_from_numpy(init, "cpu"),
                "batches": [params_from_numpy(b, "cpu") for b in batches]},
               data)
    launches = {}
    for shape in MESHES:
        d = tmp / "x".join(map(str, shape))
        d.mkdir()
        launches[shape] = _launch(d, shape, data if shape == (2, 2) else "-")
    out = {}
    try:
        for shape, ln in launches.items():
            logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in ln["procs"]]
            assert all(p.returncode == 0 for p in ln["procs"]), \
                "\n".join(logs)[-4000:]
            out[shape] = json.loads(ln["out"].read_text())
    finally:
        for ln in launches.values():
            for p in ln["procs"]:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    state = torch.load(str(launches[(2, 2)]["out"]) + ".state.pt",
                       weights_only=True)
    out["reference"] = {"losses": losses, "grad_norms": norms,
                        "final": final, "state": state}
    return out


def _runs(shape, name) -> bool:
    if len(shape) == 3:
        return name in POD_CASES
    return shape == (2, 2) or name not in ONLY_2X2


def _cases():
    return [(shape, name) for shape in MESHES for name in CASES
            if _runs(shape, name)]


_IDS = [f"{'x'.join(map(str, s))}-{n}" for s, n in _cases()]


@pytest.mark.parametrize("shape,name", _cases(), ids=_IDS)
def test_sharded_grads_match_one_rank(runs, shape, name):
    """The first step's grads on the shards, as the step's backward
    leaves them (averaged over the data axes, reduce-scattered)."""
    errs = runs[shape][name]["grad_err"]
    bad = {k: v for k, v in errs.items() if not v <= REL_TOL}
    assert not bad, bad


@pytest.mark.parametrize("shape,name", _cases(), ids=_IDS)
def test_sharded_step_matches_one_rank(runs, shape, name):
    res = runs[shape][name]
    for got, want in zip(res["metrics"], res["want"]):
        for key in ("loss", "grad_norm"):
            assert abs(got[key] - want[key]) <= REL_TOL * abs(want[key]), \
                (key, got, want)
    if "state_err" in res:
        bad = {k: v for k, v in res["state_err"].items()
               if not v <= STATE_L2_TOL and not k.endswith("/bk")}
        assert not bad, bad
    else:
        assert res["compress_equal"]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_rank_holds_only_its_shards(runs, shape):
    """Every leaf of the state at its spec's shard shape after the steps,
    none whole that its spec splits, and the grads reduce-scattered
    where ``data`` splits leaves (summed over ``model`` where it splits
    them)."""
    for name in (n for s, n in _cases() if s == shape):
        res = runs[shape][name]
        assert res["sharded"] > 0, name
        bad = {p: s for p, s in res["shapes"].items() if s[0] != s[1]}
        assert not bad, (name, bad)
        assert not res["whole"], (name, res["whole"])
        counts = res["collectives"]
        if shape[-2] > 1:
            assert counts["reduce-scatter"] > 0, (name, counts)
        if shape[-1] > 1:
            assert counts["all-reduce"] > 0, (name, counts)


def test_sharded_step_matches_reference(runs):
    """Granite with one KV head (k / v resharded along ``model``) at
    (2, 2), from the reference's state and batches, against the
    reference's single-device ``train_step_fn``: loss and grad norm per
    step, and every leaf of the final state (L2, as above)."""
    from repro_torch.tree import flatten

    ref = runs["reference"]
    got = runs[(2, 2)]["reference"]["metrics"]
    np.testing.assert_allclose([m["loss"] for m in got], ref["losses"],
                               rtol=REF_REL_TOL)
    np.testing.assert_allclose([m["grad_norm"] for m in got],
                               ref["grad_norms"], rtol=REF_REL_TOL)
    want = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(
                ref["final"])[0]}
    flat = dict(flatten(ref["state"]))
    assert set(flat) == set(want)
    for path, t in flat.items():
        w = want[path].astype(np.float64)
        err = np.linalg.norm(t.double().numpy() - w) / max(
            np.linalg.norm(w), 1e-30)
        assert err <= REF_REL_TOL, (path, err)
