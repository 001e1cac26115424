"""The port's elastic drill across process groups (the drill of
``tests/test_elastic_drill.py``, on gloo processes in place of XLA host
devices):

  8 processes train reduced granite-3-2b on a (4, 2) mesh for 4 steps and
  checkpoint -> "lose" half the cluster -> ``plan_elastic_mesh`` picks
  (2, 2) -> a second launch of 4 processes restores the checkpoint onto
  that mesh's placements (``ckpt.restore(..., mesh, specs)``) -> 3 more
  steps.

Both launches start from the reference's ``init_train_state(cfg, ocfg,
PRNGKey(0))`` and its pipeline's batches, carried across as numpy.  Each
of the 7 losses is held within 1e-4 relative of the reference's
single-device ``train_step_fn`` over the same batches (a sharded step
sums the same float32 terms in another order: the 2-rank step of
``tests/test_torch_sharding.py`` reads 1.3e-5 on the leaves), and the
restored state, gathered, must equal the saved state in bits.  Each
launch's processes meet on a ``FileStore`` and run under a timeout."""
import json
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
STEPS_BEFORE, STEPS_AFTER = 4, 3
LOSS_REL_TOL = 1e-4
TIMEOUT_S = 300

_WORKER = textwrap.dedent("""
    import json, sys
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    phase, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    store, data, ckpt_dir, out = sys.argv[4:8]
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs.registry import get_config
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.runtime.fault_tolerance import plan_elastic_mesh
    from repro_torch.sharding import partition as PP
    from repro_torch.train import train_step as ts
    from repro_torch.tree import flatten, tree_map

    cfg = get_config("granite-3-2b", reduced=True)
    ocfg = OptConfig(warmup_steps=2, decay_steps=100, peak_lr=1e-3)
    blob = torch.load(data, weights_only=True)
    batches = blob["batches"]
    if phase == "train":
        shape = (4, 2)
    else:
        plan = plan_elastic_mesh(n_healthy=world, model_parallel=2)
        shape = tuple(plan.mesh_shape)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    step_fn, pspecs, bspecs = ts.make_train_step(
        cfg, ocfg, mesh, ts.init_train_state(cfg, ocfg, device="meta"),
        batches[0])
    res = {"mesh": list(shape)}
    if phase == "train":
        state = PP.logical_to_sharding(blob["state"], pspecs, mesh)
        first, losses = 0, []
    else:
        state, extra, first = ckpt.restore(ckpt_dir, mesh=mesh, specs=pspecs)
        losses = extra["losses"]
        saved, _, _ = ckpt.restore(ckpt_dir)
        got = tree_map(lambda t: PP.full_value(t).cpu(), state)
        res["restored_bits_equal"] = all(
            a.dtype == b.dtype and torch.equal(a, b)
            for (_, a), (_, b) in zip(flatten(got), flatten(saved)))
        res["sharded_leaves"] = sum(
            tuple(t.to_local().shape) != tuple(t.shape)
            for _, t in flatten(state))
    n = 4 if phase == "train" else 3
    for s in range(first, first + n):
        batch = PP.logical_to_sharding(batches[s], bspecs, mesh)
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
    res["losses"] = losses
    # every rank gathers (a collective); one writes
    host = tree_map(lambda t: PP.full_value(t).detach().cpu(), state)
    if phase == "train" and rank == 0:
        ckpt.save(ckpt_dir, first + n, host, {"losses": losses})
    dist.barrier()
    if rank == 0:
        json.dump(res, open(out, "w"))
    dist.destroy_process_group()
""")


def _launch(tmp_path, phase: str, world: int, data, ckpt_dir) -> dict:
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    store = tmp_path / f"store_{phase}"
    out = tmp_path / f"{phase}.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), phase, str(r), str(world), str(store),
         str(data), str(ckpt_dir), str(out)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    return json.loads(out.read_text())


def _reference(n_steps: int):
    """The reference's initial state, its first ``n_steps`` batches and
    its single-device losses over them."""
    cfg = ref_config("granite-3-2b", reduced=True)
    ocfg = ROpt(warmup_steps=2, decay_steps=100, peak_lr=1e-3)
    pipe = RPipe.for_model(cfg, RShape("drill", seq_len=32, global_batch=8,
                                       kind="train"))
    state = RT.init_train_state(cfg, ocfg, jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, state)
    batches = [jax.tree.map(np.asarray, pipe.batch_at(s))
               for s in range(n_steps)]
    step = jax.jit(partial(RT.train_step_fn, cfg, ocfg))
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return init, batches, losses


def test_elastic_drill_across_process_groups(tmp_path):
    from repro_torch.convert import params_from_numpy

    init, batches, want = _reference(STEPS_BEFORE + STEPS_AFTER)
    data = tmp_path / "drill.pt"
    torch.save({"state": params_from_numpy(init, "cpu"),
                "batches": [params_from_numpy(b, "cpu") for b in batches]},
               data)
    ckpt_dir = tmp_path / "ckpt"
    first = _launch(tmp_path, "train", 8, data, ckpt_dir)
    assert first["mesh"] == [4, 2]
    assert len(first["losses"]) == STEPS_BEFORE
    second = _launch(tmp_path, "resume", 4, data, ckpt_dir)
    assert second["mesh"] == [2, 2]                # plan_elastic_mesh's
    assert second["restored_bits_equal"]
    assert second["sharded_leaves"] > 0
    got = second["losses"]
    assert got[:STEPS_BEFORE] == first["losses"]
    assert len(got) == len(want) == STEPS_BEFORE + STEPS_AFTER
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=LOSS_REL_TOL)
    assert got[-1] < got[0]
