"""The port's cost analysis (``repro_torch.launch.cost_analysis``) case by
case against ``tests/test_hlo_analysis.py``: the exact dot FLOPs of one
product, a loop of 10 scaled, nested loops of 3 x 4 scaled; one
collective on a fake 4-rank group; and its dot FLOPs against the
reference's ``analyze_hlo`` of the jitted single-device function on
reduced granite-3-2b: within 1% for ``prefill_fn`` and one decode step,
2% for ``train_step_fn`` (an eager loop runs once per iteration, where
the HLO analyzer scales a while body by its trip count)."""
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
from repro.launch.hlo_analysis import analyze_hlo  # noqa: E402
from repro.models import factory as RF  # noqa: E402
from repro.optim.adamw import OptConfig as ROpt  # noqa: E402
from repro.serve import serve_step as RS  # noqa: E402
from repro.train import train_step as RT  # noqa: E402

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch.cost_analysis import (COLLECTIVES,  # noqa: E402
                                              StepCost, analyze_step)
from repro_torch.optim.adamw import OptConfig  # noqa: E402
from repro_torch.serve import serve_step as PS  # noqa: E402
from repro_torch.train import train_step as PT  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "granite-3-2b"


def test_dot_flops_exact():
    a, b = torch.ones(64, 128), torch.ones(128, 32)
    cost = analyze_step(lambda x, y: x @ y, a, b)
    assert cost.dot_flops == 2 * 64 * 128 * 32
    assert cost.dot_bytes == (64 * 128 + 128 * 32 + 64 * 32) * 4


def test_loop_trip_count_scaling():
    def fn(x):
        for _ in range(10):
            x = x @ x
        return x

    cost = analyze_step(fn, torch.eye(64))
    # 10 iterations x one 64^3 matmul each
    assert cost.dot_flops == pytest.approx(10 * 2 * 64 ** 3, rel=0.01)


def test_nested_loop_scaling():
    def fn(x):
        for _ in range(3):
            for _ in range(4):
                x = x @ x
        return x

    cost = analyze_step(fn, torch.eye(32))
    assert cost.dot_flops == pytest.approx(12 * 2 * 32 ** 3, rel=0.01)


def test_as_dict_has_the_reference_keys():
    from repro.launch.hlo_analysis import HLOCost

    got, want = StepCost().as_dict(), HLOCost().as_dict()
    assert list(got) == list(want)
    assert list(got["collective_bytes"]) == list(want["collective_bytes"])
    assert tuple(COLLECTIVES) == tuple(want["collective_counts"])


_COLLECTIVE = textwrap.dedent("""
    import json
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.cost_analysis import analyze_step

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    flat = mesh["data", "model"]._flatten()
    t = DTensor.from_local(torch.ones(16, 32), flat, [Shard(0)],
                           run_check=False)
    cost = analyze_step(lambda d: d.redistribute(flat, [Replicate()])
                        .to_local(), t)
    print(json.dumps(cost.as_dict()))
    dist.destroy_process_group()
""")


def test_shard_to_replicate_counts_one_all_gather():
    """(64, 32) float32 sharded on dim 0 over the 4 ranks of a (2, 2)
    mesh (flattened) -> replicated: one all-gather of its 2048 local
    bytes, and no other collective."""
    import json

    proc = subprocess.run([sys.executable, "-c", _COLLECTIVE],
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["collective_counts"] == {**dict.fromkeys(COLLECTIVES, 0),
                                        "all-gather": 1}
    assert got["collective_bytes"]["all-gather"] == 2048
    assert got["collective_total_bytes"] == 2048


# -- against the reference's analyze_hlo on reduced granite-3-2b -----------
def _ref_dot_flops(fn, *args) -> float:
    hlo = jax.jit(fn).lower(*args).compile().as_text()
    return analyze_hlo(hlo).dot_flops


@pytest.fixture(scope="module")
def granite():
    rcfg = ref_config(ARCH, reduced=True)
    pcfg = get_config(ARCH, reduced=True)
    params = RF.init_params(rcfg, jax.random.PRNGKey(0))
    return rcfg, pcfg, params


def test_prefill_dot_flops_match_analyze_hlo(granite):
    rcfg, pcfg, params = granite
    toks = np.random.default_rng(0).integers(
        0, rcfg.vocab_size, (2, 64)).astype(np.int32)
    want = _ref_dot_flops(partial(RS.prefill_fn, rcfg), params,
                          {"tokens": toks})
    with torch.no_grad():
        got = analyze_step(PS.prefill_fn, pcfg,
                           params_from_numpy(params, "cpu"),
                           {"tokens": torch.from_numpy(toks)}).dot_flops
    assert got == pytest.approx(want, rel=0.01)


def test_decode_dot_flops_match_analyze_hlo(granite):
    rcfg, pcfg, params = granite
    b, s = 2, 64
    cache = RF.init_cache(rcfg, b, s)
    toks = np.random.default_rng(1).integers(
        0, rcfg.vocab_size, (b, 1)).astype(np.int32)
    want = _ref_dot_flops(partial(RS.serve_step_fn, rcfg), params, cache,
                          {"tokens": toks})
    pcache = params_from_numpy(jax.tree.map(np.asarray, cache), "cpu")
    with torch.no_grad():
        got = analyze_step(PS.serve_step_fn, pcfg,
                           params_from_numpy(params, "cpu"), pcache,
                           {"tokens": torch.from_numpy(toks)}).dot_flops
    assert got == pytest.approx(want, rel=0.01)


def test_train_step_dot_flops_match_analyze_hlo(granite):
    rcfg, pcfg, _ = granite
    rocfg = ROpt(warmup_steps=2, decay_steps=100, peak_lr=1e-3)
    state = RT.init_train_state(rcfg, rocfg, jax.random.PRNGKey(0))
    batch = jax.tree.map(np.asarray, RPipe.for_model(
        rcfg, RShape("t", seq_len=64, global_batch=4, kind="train")
    ).batch_at(0))
    pstate = params_from_numpy(jax.tree.map(np.asarray, state), "cpu")
    want = _ref_dot_flops(partial(RT.train_step_fn, rcfg, rocfg), state,
                          batch)
    got = analyze_step(
        PT.train_step_fn, pcfg,
        OptConfig(warmup_steps=2, decay_steps=100, peak_lr=1e-3), pstate,
        params_from_numpy(batch, "cpu")).dot_flops
    assert got == pytest.approx(want, rel=0.02)
