"""The port's trainer, checkpoints and launcher: the counterparts of
``tests/test_train_and_ckpt.py`` (loss decrease, bitwise resume,
microbatches, compressed training, the error-feedback bound, the AdamW
state, checkpoint atomicity, corruption and GC, restore onto a mesh) and
of the reference launcher's ``main()``, on a one-rank gloo mesh on the
CPU at the reduced granite-3-2b."""
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.optim import compression  # noqa: E402
from repro_torch.optim.adamw import (OptConfig, apply_updates,  # noqa: E402
                                     init_opt_state)
from repro_torch.sharding.partition import full_value  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

CFG = get_config("granite-3-2b", reduced=True)
SHAPE = ShapeConfig("tiny", seq_len=32, global_batch=4, kind="train")
OCFG = OptConfig(warmup_steps=2, decay_steps=200, peak_lr=1e-3)


def _trainer(tmp, **kw):
    return Trainer(CFG, SHAPE, make_local_mesh(device="cpu"), OCFG,
                   TrainerConfig(ckpt_dir=tmp, ckpt_every=5, log_every=1000,
                                 **kw))


def _host(tree) -> dict:
    return {k: full_value(v).clone() for k, v in flatten(tree)}


def test_loss_decreases(tmp_path):
    tr = _trainer(str(tmp_path / "a"))
    assert tr.init_or_resume() == ("fresh", 0)
    first = float(tr.train(1)["loss"])
    last = float(tr.train(25)["loss"])
    assert last < first - 0.1, (first, last)


def test_resume_is_bitwise(tmp_path):
    """7 steps (a checkpoint at 5), then a new trainer resumes at 5 and
    takes 2: every leaf of the state has the same bits, the data state
    and the optimizer's step came back."""
    d = str(tmp_path / "b")
    tr = _trainer(d)
    tr.init_or_resume()
    tr.train(7)
    want = _host(tr.state)
    tr2 = _trainer(d)
    assert tr2.init_or_resume() == ("resumed", 5)
    assert int(full_value(tr2.state["opt"]["step"])) == 5
    tr2.train(2)
    got = _host(tr2.state)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_microbatch_matches_full_batch(tmp_path):
    tr1 = _trainer(str(tmp_path / "c1"))
    tr2 = _trainer(str(tmp_path / "c2"), microbatches=2)
    tr1.init_or_resume()
    tr2.init_or_resume()
    tr1.train(3)
    tr2.train(3)
    p1, p2 = _host(tr1.state["params"]), _host(tr2.state["params"])
    diffs = [float((p1[k] - p2[k]).abs().max()) for k in p1]
    assert max(diffs) < 5e-5     # accumulation reorders float sums


def test_compressed_training_converges(tmp_path):
    tr = _trainer(str(tmp_path / "d"), compress_grads=True)
    tr.init_or_resume()
    assert "ef_error" in tr.state
    first = float(tr.train(1)["loss"])
    last = float(tr.train(20)["loss"])
    assert last < first - 0.05


def test_grad_compression_error_feedback():
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.standard_normal((64, 64)) * 1e-3)}
    err = compression.init_error_state(g)
    deq, err = compression.ef_compress_grads(g, err)
    scale = float(g["w"].abs().max()) / 127
    assert float((deq["w"] - g["w"]).abs().max()) <= scale * 0.5 + 1e-12
    total_true = torch.zeros((64, 64), dtype=torch.float64)
    total_sent = torch.zeros((64, 64), dtype=torch.float64)
    err = compression.init_error_state(g)
    for _ in range(50):
        gi = {"w": torch.from_numpy(rng.standard_normal((64, 64)) * 1e-3)}
        total_true += gi["w"]
        deq, err = compression.ef_compress_grads(gi, err)
        total_sent += deq["w"]
    assert float((total_true - total_sent).abs().max()) <= scale * 2


def test_adamw_step_shapes():
    params = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    st = init_opt_state(OCFG, params)
    assert "master" in st                # bf16 params need a master copy
    assert "master" not in init_opt_state(OCFG, {"w": torch.ones(4)})
    p2, st2, m = apply_updates(OCFG, params, {"w": torch.ones((4, 4))}, st)
    assert p2["w"].dtype == torch.bfloat16
    assert int(st2["step"]) == 1 and float(m["grad_norm"]) > 0


# ---------------- checkpoints ---------------------------------------------
def test_ckpt_atomic_and_corrupt_detection(tmp_path):
    d = str(tmp_path / "ck")
    state = {"x": torch.arange(10), "h": torch.ones(3, dtype=torch.bfloat16)}
    ckpt.save(d, 3, state, {"note": "hi"})
    os.makedirs(os.path.join(d, "step_00000007.tmp"))   # a torn write
    assert ckpt.latest_step(d) == 3
    st, extra, step = ckpt.restore(d)
    assert step == 3 and extra["note"] == "hi"
    assert torch.equal(st["x"], torch.arange(10))
    assert st["h"].dtype == torch.bfloat16
    with open(os.path.join(d, "step_00000003", ckpt._DATA), "r+b") as f:
        f.seek(5)
        f.write(b"\x00\x01")
    with pytest.raises(IOError, match="corrupt"):
        ckpt.restore(d, 3)


def test_ckpt_gc_and_async(tmp_path):
    d = str(tmp_path / "gc")
    for s in (1, 2, 3, 4):
        ckpt.save(d, s, {"s": torch.tensor(s)})
    t = ckpt.save_async(d, 5, {"s": torch.tensor(5)})
    t.join(timeout=60)
    assert not t.is_alive()
    ckpt.gc_keep_last(d, keep=2)
    assert ckpt.list_steps(d) == [4, 5]
    assert int(ckpt.restore(d)[0]["s"]) == 5


def test_restore_places_onto_the_mesh(tmp_path):
    from torch.distributed.tensor import DTensor
    d = str(tmp_path / "el")
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    ckpt.save(d, 1, {"w": w})
    mesh = make_local_mesh(device="cpu")
    st, _, _ = ckpt.restore(d, 1, mesh=mesh, specs={"w": ("data", "model")})
    assert isinstance(st["w"], DTensor)
    assert torch.equal(full_value(st["w"]), w)


def test_launcher_trains_and_resumes(tmp_path, capsys):
    d = str(tmp_path / "run")
    args = ["--arch", "granite-3-2b", "--reduced", "--seq-len", "32",
            "--global-batch", "4", "--ckpt-dir", d, "--device", "cpu"]
    launch_train.main(args + ["--steps", "10"])
    out = capsys.readouterr().out
    assert "fresh at step 0; devices=1 mesh={'data': 1, 'model': 1}" in out
    assert f"done at step 10; checkpoints in {d}" in out
    launch_train.main(args + ["--steps", "12"])
    out = capsys.readouterr().out
    assert "resumed at step 10" in out and "done at step 12" in out
    assert ckpt.latest_step(d) == 12
