"""The port's twins of the two examples that had none, run on the CPU:

* ``examples/train_tiny_lm_torch.py`` (the twin of
  ``examples/train_tiny_lm.py``: its 11.0M granite through ``Trainer`` on
  ``make_local_mesh``, a checkpoint and exact resume) for 3 steps at
  its own shape, against the same run stopped after 2 steps and
  resumed from its checkpoint: the resumed state equals the unbroken
  one's in bits, leaf for leaf;
* ``examples/espim_schedule_viz_torch.py`` prints the reference
  example's output exactly (the same seed through the port's copies of
  ``pim_sim``, ``pruning`` and ``sdds``)."""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
CPU = ("--device", "cpu")


def _tiny_lm():
    spec = importlib.util.spec_from_file_location(
        "train_tiny_lm_torch", ROOT / "examples" / "train_tiny_lm_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_tiny_lm_resumes_exactly(tmp_path, capsys):
    from repro_torch.sharding import partition
    from repro_torch.tree import flatten

    mod = _tiny_lm()
    # on several threads the CPU's reductions add in the order the
    # threads finish, so two unbroken runs at this shape differ in the
    # last bit; on one they add in one order
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        whole = mod.main(["--steps", "3", "--ckpt-dir", str(tmp_path / "a"),
                          *CPU])
        first = mod.main(["--steps", "2", "--ckpt-dir", str(tmp_path / "b"),
                          *CPU])
        again = mod.main(["--steps", "3", "--ckpt-dir", str(tmp_path / "b"),
                          *CPU])
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert "fresh at step 0" in out and "resumed at step 2" in out
    assert whole.step == again.step == 3 and first.step == 2
    want = dict(flatten(whole.state))
    got = dict(flatten(again.state))
    assert set(got) == set(want)
    for path, t in got.items():
        assert torch.equal(partition.full_value(t),
                           partition.full_value(want[path])), path


def test_espim_schedule_viz_prints_the_reference_output():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / name)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in ("espim_schedule_viz.py", "espim_schedule_viz_torch.py")]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-2000:] for o in outs]
    ref, port = (o[0] for o in outs)
    assert "vs Newton" in port and "MAC occupancy" in port
    assert port == ref
