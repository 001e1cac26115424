"""The sharded train step (``train_step.make_train_step``: ZeRO-3 on
``data``, tensor parallelism on ``model``, the sharded AdamW) of every
family on gloo process groups, against the world-size-1 step and the JAX
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
    ``data`` only) granite with one KV head and nemotron;
  * at (2, 1) and (2, 2) phi3.5-moe in 2 microbatches (the microbatch
    fault: each rank's microbatch i is its part of the global batch's
    microbatch i), sharded and gathered;
  * the microbatch fault below the data ranks: granite at B 2 in 2
    microbatches of one row on (2, 1) and (2, 2), sharded and gathered,
    and phi3.5-moe so on (2, 1) (a microbatch runs whole on every data
    rank, and so does its dispatch group); granite at B 4 in 2
    microbatches on (2, 2, 2), whose rows of 2 split over ``pod`` and
    run whole over ``data``;
  * at (2, 2) and (1, 4) the hybrid, audio and ssm families: zamba2
    (2 layers: one group, the shared block once), whisper (its encoder
    on random ``frames``) and rwkv6 (1 layer, peak lr 3e-4).  The cuts
    bring the world-size-1 step's own conditioning down to the size of
    the bounds (``scripts/spmd_depth_gap.py``: a 1e-7 relative
    perturbation of the initial params, worst of three seeds, moves the
    world-size-1 step's 3-step state by 1.0e-4 in L2 for zamba2 at its
    reduced 6 layers and 2.6e-5 at 2, and rwkv6's first-step grads by
    4.3e-5 and its state by 2.7e-3 at 4 layers and lr 1e-3, 1.5e-5 and
    2.1e-5 at 1 layer and lr 3e-4).  At the full depth the same script
    puts the sharded step within 1.5x of that perturbation on (2, 2)
    and (1, 4): no fault of stacked layers shows above rounding.

With microbatches the first step's grads are the microbatches' mean on
both sides (``train_step._loss_and_grads``).

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

The (2, 2) launch also runs granite with one KV head, phi3.5-moe,
qwen2-vl, zamba2, whisper and rwkv6 (as in ``CASES``) from the
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
MESHES = ((2, 1), (1, 2), (2, 2), (2, 2, 2), (1, 4))
MOE = "phi3.5-moe-42b-a6.6b"
# name -> (arch, config overrides, microbatches, compress_grads, extras:
# "seq" / "batch" in place of S 16 x B 4, "gathered" to run the step
# with ``factory.shards`` answering False, "vision" for a batch with
# M-RoPE positions and spliced embeddings)
CASES = {
    "granite": ("granite-3-2b", {}, 1, False, {}),
    "nemotron": ("nemotron-4-15b", {}, 1, False, {}),
    "granite_kv1": ("granite-3-2b", {"n_kv_heads": 1}, 1, False, {}),
    "qwen_h3": ("qwen2.5-14b", {"n_heads": 3, "n_kv_heads": 1}, 1, False,
                {}),
    "granite_mb2": ("granite-3-2b", {}, 2, False, {}),
    "granite_ef": ("granite-3-2b", {}, 1, True, {}),
    # 32 tokens a data rank in groups of 64: the groups span the ranks,
    # and at capacity factor 1 (32 slots an expert) tokens drop
    "moe_span": (MOE, {"capacity_factor": 1.0}, 1, False, {}),
    # groups of 32: each data rank's tokens are a whole group
    "moe_align": (MOE, {"moe_group_size": 32}, 1, False, {}),
    # the fault: B 2 x S 32 on (2, 1), one group over both ranks, on
    # the sharded path and on the gathered one
    "moe_fault": (MOE, {}, 1, False, {"seq": 32, "batch": 2}),
    "moe_fault_gathered": (MOE, {}, 1, False,
                           {"seq": 32, "batch": 2, "gathered": True}),
    "vlm": ("qwen2-vl-2b", {}, 1, False, {"vision": True}),
    # the microbatch fault: B 4 x S 16 in 2 microbatches of the global
    # batch (groups of 64 tokens over both data ranks), sharded and
    # gathered
    "moe_mb2": (MOE, {}, 2, False, {}),
    "moe_mb2_gathered": (MOE, {}, 2, False, {"gathered": True}),
    # the microbatch fault below the data ranks: B 2 in 2 microbatches
    # of one row, which run whole on every data rank (sharded, gathered,
    # MoE), and B 4 on (2, 2, 2), whose rows of 2 split over ``pod`` only
    "granite_b2_mb2": ("granite-3-2b", {}, 2, False, {"batch": 2}),
    "granite_b2_mb2_gathered": ("granite-3-2b", {}, 2, False,
                                {"batch": 2, "gathered": True}),
    "moe_b2_mb2": (MOE, {}, 2, False, {"batch": 2}),
    "granite_pod_mb2": ("granite-3-2b", {}, 2, False, {}),
    # the hybrid, audio and ssm families (frames for whisper's encoder)
    "zamba2": ("zamba2-2.7b", {"n_layers": 2}, 1, False, {}),
    "whisper": ("whisper-small", {}, 1, False, {"audio": True}),
    "rwkv6": ("rwkv6-1.6b", {"n_layers": 1}, 1, False, {"lr": 3e-4}),
}
ONLY_2X2 = ("granite_mb2", "granite_ef")
ONLY_2X1 = ("moe_fault", "moe_fault_gathered", "moe_b2_mb2")
MB_CASES = ("moe_mb2", "moe_mb2_gathered", "granite_b2_mb2",
            "granite_b2_mb2_gathered")         # on (2, 1) and (2, 2)
POD_CASES = ("granite_kv1", "nemotron", "granite_pod_mb2")  # on (2, 2, 2)
ONLY_POD = ("granite_pod_mb2",)
WIDE_CASES = ("moe_span",)                     # on (1, 4): one expert a rank
FAMILY_CASES = ("zamba2", "whisper", "rwkv6")  # on (2, 2) and (1, 4)
FAULT_CASES = {(2, 1): ("granite_b2_mb2", "granite_b2_mb2_gathered",
                        "moe_b2_mb2"),
               (2, 2): ("granite_b2_mb2", "granite_b2_mb2_gathered"),
               (2, 2, 2): ("granite_pod_mb2",)}
MOE_CASES = ("moe_span", "moe_align", "moe_fault", "moe_fault_gathered")
# the reference's state and batches, run at (2, 2): name -> (arch,
# config overrides, extras)
REF_CASES = {"granite_kv1": ("granite-3-2b", {"n_kv_heads": 1}, {}),
             "moe_span": (MOE, {"capacity_factor": 1.0}, {}),
             "vlm": ("qwen2-vl-2b", {}, {"vision": True}),
             "zamba2": ("zamba2-2.7b", {"n_layers": 2}, {}),
             "whisper": ("whisper-small", {}, {"audio": True}),
             "rwkv6": ("rwkv6-1.6b", {"n_layers": 1}, {"lr": 3e-4})}

# the vision extras of a VLM batch, made alike by the workers and for the
# reference: M-RoPE positions whose three sections differ, patch
# embeddings, and the first quarter of each row marked visual
_VISION = textwrap.dedent("""
    def vision_extras(b, s, d, step):
        import numpy as np
        rng = np.random.RandomState(100 + step)
        t = np.arange(s)
        pos = np.stack([t // 4, t % 4 + t // 8, (3 * t) % 7 + t // 2])
        pos = (pos[:, None, :] + rng.randint(0, 3, (3, b, 1))).astype(
            np.int32)
        emb = rng.standard_normal((b, s, d)).astype(np.float32) * 0.02
        mask = np.zeros((b, s), bool)
        mask[:, :s // 4] = True
        return {"positions3": pos, "embeddings": emb, "vis_mask": mask}

    def audio_extras(b, t, d, step):
        import numpy as np
        rng = np.random.RandomState(200 + step)
        return {"frames": rng.standard_normal((b, t, d)).astype(
            np.float32)}
""")
exec(_VISION)

_WORKER = _VISION + textwrap.dedent("""
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
    from repro_torch.models import factory, moe
    from repro_torch.optim import compression
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.sharding import partition as PP
    from repro_torch.train import train_step as ts
    from repro_torch.tree import flatten, tree_map

    mesh = init_device_mesh("cpu", shape, mesh_dim_names=(
        ("pod", "data", "model") if len(shape) == 3 else ("data", "model")))
    ocfg = OptConfig(warmup_steps=2, decay_steps=20, peak_lr=1e-3)
    SHARDS = factory.shards
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

    def with_vision(batch, cfg, step, extra):
        b, s = batch["tokens"].shape
        if extra.get("audio"):
            more = audio_extras(b, cfg.encoder_seq, cfg.d_model, step)
        elif extra.get("vision"):
            more = vision_extras(b, s, cfg.d_model, step)
        else:
            return batch
        return dict(batch, **{k: torch.from_numpy(v)
                              for k, v in more.items()})

    def metric(m):
        return {k: float(m[k]) for k in ("loss", "grad_norm", "aux")
                if k in m}

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
            metrics.append(metric(m))
        return placed, pspecs, bspecs, metrics, counts

    for name, (arch, over, mb, ef, extra) in cases.items():
        cfg = get_config(arch, reduced=True).replace(**over)
        ocfg = OptConfig(warmup_steps=2, decay_steps=20,
                         peak_lr=extra.get("lr", 1e-3))
        factory.shards = ((lambda cfg, mesh: False) if extra.get("gathered")
                          else SHARDS)
        pipe = SyntheticPipeline.for_model(
            cfg, ShapeConfig("t", extra.get("seq", 16),
                             extra.get("batch", 4), "train"), device="cpu")
        batches = [with_vision(pipe.batch_at(i), cfg, i, extra)
                   for i in range(%(steps)d)]

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
            want.append(metric(m))
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
                            for s in flat_s.values()),
             "path": "sharded" if factory.shards(cfg, mesh) else "gathered"}
        if cfg.family == "moe":
            r["experts"] = [
                placed["params"]["layers"]["moe"][k].to_local().shape[1]
                for k in ("w_gate", "w_up", "w_down")] + [
                cfg.n_experts // PP.mesh_axis_size(mesh, "model")]
        if not ef:
            r["state_err"] = vs_slices(placed, plain, pspecs, l2_rel)
        # the first step's grads on the shards (its microbatches' mean)
        # against the whole batch's
        state0 = PP.logical_to_sharding(init(), pspecs, mesh)
        placed_b0 = PP.logical_to_sharding(batches[0], bspecs, mesh)
        b0, blayout = local(placed_b0), PP.Layout.of(placed_b0)
        split = moe.Split(mesh, bspecs["tokens"][0])
        if r["path"] == "sharded":
            layout = PP.Layout.of(state0["params"])
            _, _, g = ts._loss_and_grads(cfg, local(state0["params"]), b0,
                                         mb, None, layout, split, blayout)
        else:
            full = tree_map(PP.full_value, state0["params"])
            _, _, g = ts._loss_and_grads(cfg, full, b0, mb,
                                         ts._data_reduce(mesh), None, split,
                                         blayout)
            g = tree_map(lambda t, sp: PP.local_slice(t, sp, mesh), g,
                         pspecs["params"])
        _, _, g1 = ts._loss_and_grads(cfg, init()["params"], batches[0], mb)
        r["grad_err"] = vs_slices(g, g1, pspecs["params"], max_rel)
        if mb > 1:
            # each rank's microbatch i: its part of the global batch's
            # along the axes that split a microbatch, whole along the rest
            mine = ts._split_microbatches(b0, mb, blayout)
            glob = ts._split_microbatches(batches[0], mb)
            b_ax = bspecs["tokens"][0]
            mb_ax = ts.microbatch_axes(b0, mb, blayout)
            r["mb_axes"] = [list(PP.axis_names(b_ax)),
                            list(PP.axis_names(mb_ax))]
            mb_specs = tree_map(lambda sp: tuple(
                mb_ax if a == b_ax and a is not None else a for a in sp),
                bspecs)
            r["rows_equal"] = all(
                torch.equal(t, PP.local_slice(dict(flatten(want))[p],
                                              dict(flatten(mb_specs))[p],
                                              mesh))
                for got, want in zip(mine, glob) for p, t in flatten(got))
        if ef:
            # the sharded compression on the shards of given grads and
            # residuals against the whole leaves'
            layout = PP.Layout.of(state0["params"])
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
    factory.shards = SHARDS

    # the JAX reference's initial state and batches
    refs = {} if data == "-" else json.loads(data)
    res["reference"] = {}
    for name, path in refs.items():
        blob = torch.load(path, weights_only=True)
        arch, over, extra = %(ref_cases)r[name]
        cfg = get_config(arch, reduced=True).replace(**over)
        ocfg = OptConfig(warmup_steps=2, decay_steps=20,
                         peak_lr=extra.get("lr", 1e-3))
        placed, _, _, metrics, _ = run(cfg, blob["state"], blob["batches"],
                                       1, False)
        full = tree_map(lambda t: PP.full_value(t).detach(), placed)
        if rank == 0:
            torch.save(full, f"{out}.{name}.state.pt")
        res["reference"][name] = {"metrics": metrics}
    if rank == 0:
        json.dump(res, open(out, "w"))
    dist.destroy_process_group()
""") % {"steps": STEPS, "ref_cases": REF_CASES}


def _reference(name):
    """The reference's initial state, batches and single-device run of
    ``REF_CASES[name]``: (init, batches, losses, grad norms, final state)
    as numpy."""
    arch, over, extra = REF_CASES[name]
    cfg = ref_config(arch, reduced=True).replace(**over)
    ocfg = ROpt(warmup_steps=2, decay_steps=20,
                peak_lr=extra.get("lr", 1e-3))
    pipe = RPipe.for_model(cfg, RShape("t", seq_len=16, global_batch=4,
                                       kind="train"))
    state = RT.init_train_state(cfg, ocfg, jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, state)
    batches = []
    for s in range(STEPS):
        b = jax.tree.map(np.asarray, pipe.batch_at(s))
        if extra.get("vision"):
            b.update(vision_extras(*b["tokens"].shape, cfg.d_model, s))
        if extra.get("audio"):
            b.update(audio_extras(b["tokens"].shape[0], cfg.encoder_seq,
                                  cfg.d_model, s))
        batches.append(b)
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
         str(tmp_path / f"store_{tag}"), data, str(out),
         json.dumps(shape), json.dumps(cases)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    return {"procs": procs, "out": out}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh's launch, started together (the (2, 2) one once the
    reference's runs, which it replays, are done)."""
    from repro_torch.convert import params_from_numpy

    tmp = tmp_path_factory.mktemp("spmd_train")

    def launch(shape, data="-"):
        d = tmp / "x".join(map(str, shape))
        d.mkdir()
        return _launch(d, shape, data)

    launches = {s: launch(s) for s in MESHES if s != (2, 2)}
    out, data = {"reference": {}}, {}
    try:
        for name in REF_CASES:
            init, batches, losses, norms, final = _reference(name)
            data[name] = str(tmp / f"reference_{name}.pt")
            torch.save({"state": params_from_numpy(init, "cpu"),
                        "batches": [params_from_numpy(b, "cpu")
                                    for b in batches]}, data[name])
            out["reference"][name] = {"losses": losses, "grad_norms": norms,
                                      "final": final}
        launches[(2, 2)] = launch((2, 2), json.dumps(data))
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
    for name in REF_CASES:
        out["reference"][name]["state"] = torch.load(
            f"{launches[(2, 2)]['out']}.{name}.state.pt", weights_only=True)
    return out


def _runs(shape, name) -> bool:
    if len(shape) == 3:
        return name in POD_CASES
    if name in ONLY_POD:
        return False
    if name in FAMILY_CASES:
        return shape in ((2, 2), (1, 4))
    if shape == (1, 4):
        return name in WIDE_CASES
    if name in ONLY_2X1:
        return shape == (2, 1)
    if name in MB_CASES:
        return shape in ((2, 1), (2, 2))
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
        assert got.keys() == want.keys()
        for key in got:
            assert abs(got[key] - want[key]) <= REL_TOL * abs(want[key]), \
                (key, got, want)
    if "state_err" in res:
        bad = {k: v for k, v in res["state_err"].items()
               if not v <= STATE_L2_TOL and not k.endswith("/bk")}
        assert not bad, bad
    else:
        assert res["compress_equal"]


_MOE = [(s, n) for s, n in _cases() if n in MOE_CASES]


@pytest.mark.parametrize("shape,name", _MOE,
                         ids=[f"{'x'.join(map(str, s))}-{n}" for s, n in _MOE])
def test_moe_router_and_expert_grads(runs, shape, name):
    """MoE: the router's first-step grads apart from the experts' (each
    rank computes every token's routing and its experts' share of the
    aux loss, so the router's grad is partial on every rank and must be
    summed over ``model`` once), the aux loss of every step, and the
    path and experts a rank holds: ``n_experts / model`` of them."""
    res = runs[shape][name]
    errs = res["grad_err"]
    router = {k: v for k, v in errs.items() if k.endswith("moe/router")}
    experts = {k: v for k, v in errs.items()
               if "/moe/w_" in "/" + k}
    assert len(router) == 1 and len(experts) == 3, sorted(errs)
    assert all(v <= REL_TOL for v in router.values()), router
    assert all(v <= REL_TOL for v in experts.values()), experts
    for got, want in zip(res["metrics"], res["want"]):
        assert abs(got["aux"] - want["aux"]) <= REL_TOL * want["aux"], \
            (got, want)
    gathered = CASES[name][4].get("gathered", False)
    assert res["path"] == ("gathered" if gathered else "sharded")
    assert res["experts"][:3] == [res["experts"][3]] * 3, res["experts"]


def test_moe_fault_groups_span_ranks(runs):
    """The fault repaired first: reduced phi3.5-moe at B 2 x S 32 on
    (2, 1), one dispatch group of 64 tokens over both data ranks.  The
    loss, the aux loss and every first-step grad equal the world-size-1
    step's within ``REL_TOL``, on the sharded path and on the gathered
    one (which ran each rank's 32 tokens as a group of their own, and
    read the aux loss 8.8% high)."""
    for name in ("moe_fault", "moe_fault_gathered"):
        res = runs[(2, 1)][name]
        got, want = res["metrics"][0], res["want"][0]
        for key in ("loss", "aux"):
            assert abs(got[key] - want[key]) <= REL_TOL * abs(want[key]), \
                (name, key, got, want)
        bad = {k: v for k, v in res["grad_err"].items() if not v <= REL_TOL}
        assert not bad, (name, bad)


@pytest.mark.parametrize("shape,name", [(s, n) for s in ((2, 1), (2, 2))
                                        for n in MB_CASES],
                         ids=[f"{'x'.join(map(str, s))}-{n}"
                              for s in ((2, 1), (2, 2)) for n in MB_CASES])
def test_moe_microbatches_are_the_global_rows(runs, shape, name):
    """The microbatch fault repaired: reduced phi3.5-moe at B 4 x S 16 in
    2 microbatches, each rank's microbatch i exactly its part of the
    global batch's microbatch i (the reference splits the global batch
    under ``jit``), so every loss and every first-step grad (the two
    microbatches' mean) is within ``REL_TOL`` of the world-size-1 step's
    on the sharded path and on the gathered one.  Each rank split its
    own rows before, so its microbatches' dispatch groups held other
    tokens: loss 6.577869 against 6.578063 on (2, 1)."""
    res = runs[shape][name]
    assert res["rows_equal"]
    for got, want in zip(res["metrics"], res["want"]):
        assert abs(got["loss"] - want["loss"]) <= REL_TOL * abs(
            want["loss"]), (got, want)
    bad = {k: v for k, v in res["grad_err"].items() if not v <= REL_TOL}
    assert not bad, bad


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_rank_holds_only_its_shards(runs, shape):
    """Every leaf of the state at its spec's shard shape after the steps,
    none whole that its spec splits, and on the sharded path the grads
    reduce-scattered where ``data`` splits leaves (summed over ``model``
    where it splits them)."""
    for name in (n for s, n in _cases() if s == shape):
        res = runs[shape][name]
        assert res["sharded"] > 0, name
        bad = {p: s for p, s in res["shapes"].items() if s[0] != s[1]}
        assert not bad, (name, bad)
        assert not res["whole"], (name, res["whole"])
        if res["path"] == "gathered":
            continue
        counts = res["collectives"]
        if shape[-2] > 1:
            assert counts["reduce-scatter"] > 0, (name, counts)
        if shape[-1] > 1:
            assert counts["all-reduce"] > 0, (name, counts)


def _vs_reference(runs, name):
    from repro_torch.tree import flatten

    ref = runs["reference"][name]
    got = runs[(2, 2)]["reference"][name]["metrics"]
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
        if path.endswith("/bk"):        # its exact gradient is zero (above)
            continue
        w = want[path].astype(np.float64)
        err = np.linalg.norm(t.double().numpy() - w) / max(
            np.linalg.norm(w), 1e-30)
        assert err <= REF_REL_TOL, (path, err)


def test_sharded_step_matches_reference(runs):
    """Granite with one KV head (k / v resharded along ``model``) at
    (2, 2), from the reference's state and batches, against the
    reference's single-device ``train_step_fn``: loss and grad norm per
    step, and every leaf of the final state (L2, as above)."""
    _vs_reference(runs, "granite_kv1")


@pytest.mark.parametrize("name", ("moe_span", "vlm", "zamba2", "whisper",
                                  "rwkv6"))
def test_family_sharded_step_matches_reference(runs, name):
    """As above for phi3.5-moe (experts on ``model``, groups across the
    data ranks, tokens dropped; the loss with its aux term), qwen2-vl
    (M-RoPE positions whose sections differ, the vision splice), zamba2
    (the Mamba2 mixer on a rank's SSD heads), whisper (the encoder on
    the reference's frames) and rwkv6 (the time mix on a rank's heads,
    at 1 layer and peak lr 3e-4 as in ``CASES``)."""
    _vs_reference(runs, name)


@pytest.mark.parametrize("shape,name", [(s, n) for s, names in
                                        FAULT_CASES.items() for n in names],
                         ids=[f"{'x'.join(map(str, s))}-{n}" for s, names in
                              FAULT_CASES.items() for n in names])
def test_microbatch_below_data_ranks(runs, shape, name):
    """The fault repaired first: a microbatch whose rows do not divide
    over the batch axes runs whole on every rank of the axes beyond the
    major part that divides them (B 2 in 2 microbatches: whole on
    ``data``; B 4 on (2, 2, 2): split over ``pod``, whole over
    ``data``), on the sharded path and on the gathered one, and for MoE
    with a dispatch group that names no whole axis.  Each rank's rows
    are its part of the global microbatch along those axes, and the
    loss and every first-step grad are within ``REL_TOL`` of the
    world-size-1 step.  It raised before ("a microbatch of shape (1, 16)
    does not split over ('data', None)")."""
    res = runs[shape][name]
    want_axes = ["pod"] if len(shape) == 3 else []
    assert res["mb_axes"][1] == want_axes, res["mb_axes"]
    assert res["rows_equal"]
    assert res["path"] == ("gathered" if CASES[name][4].get("gathered")
                           else "sharded")
    for got, want in zip(res["metrics"], res["want"]):
        assert abs(got["loss"] - want["loss"]) <= REL_TOL * abs(
            want["loss"]), (got, want)
    bad = {k: v for k, v in res["grad_err"].items() if not v <= REL_TOL}
    assert not bad, bad


@pytest.mark.parametrize("shape", ((2, 2), (1, 4)),
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", FAMILY_CASES)
def test_families_take_the_sharded_path(runs, shape, name):
    """zamba2, whisper and rwkv6 keep their state at its shards: the
    sharded path, every leaf at its shard shape, the grads
    reduce-scattered along ``data`` and summed over ``model``."""
    res = runs[shape][name]
    assert res["path"] == "sharded"
    assert not res["whole"], res["whole"]
    counts = res["collectives"]
    if shape[0] > 1:
        assert counts["reduce-scatter"] > 0, counts
    assert counts["all-reduce"] > 0, counts
