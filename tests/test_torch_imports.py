"""The port stands alone: importing every module of ``repro_torch`` pulls
in neither jax nor the JAX package, no source file of the port (or
``chip_smoke.py``) imports them, and the entry points run on CUDA unless
the caller asks for the CPU — without a card they raise."""
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_torch)|"
    r"from\s+repro\b(?!_torch))", re.M)


def _port_modules():
    import repro_torch
    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]


def test_importing_every_module_leaves_jax_and_repro_out():
    mods = _port_modules()
    for m in ("kernels.espim_spmv", "kernels.dense_mv",
              "kernels.flash_attention", "core.espim_linear",
              "core.pim_sim", "core.energy", "models.factory",
              "runtime.fault_tolerance", "telemetry.timeline",
              "serve.snapshot", "serve.faults", "launch.serve",
              "telemetry.profile", "telemetry.regression", "autotune.cache",
              "autotune.tuner", "models.layers", "models.transformer",
              "models.moe", "models.vlm", "models.whisper", "models.rwkv",
              "models.mamba", "serve.serve_step", "convert",
              "sharding.partition", "launch.mesh", "launch.train",
              "optim.adamw", "optim.compression", "data.pipeline",
              "train.train_step", "train.trainer", "checkpoint.ckpt",
              "tree"):
        assert f"repro_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_source_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "examples" /
                                          "quickstart_torch.py",
                                          ROOT / "examples" /
                                          "serve_sparse_llm_torch.py",
                                          ROOT / "examples" /
                                          "train_tiny_lm_torch.py",
                                          ROOT / "examples" /
                                          "espim_schedule_viz_torch.py",
                                          ROOT / "scripts" /
                                          "spmv_tile_ab.py",
                                          ROOT / "scripts" /
                                          "attn_tile_ab.py"]
    assert len(files) > 20
    for f in files:
        hit = _FORBIDDEN.search(f.read_text())
        assert hit is None, f"{f.relative_to(ROOT)}: {hit.group(0).strip()}"


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    from repro_torch.configs.registry import get_config
    from repro_torch.core.sparse_model import (decode_step_sparse,
                                               sparsify_model)
    from repro_torch.models.transformer import init_cache, init_params
    from repro_torch.serve.engine import ServeEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("llama7b-espim", reduced=True).replace(n_layers=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sparsify_model(cfg, params, 0.9)
    sparse = sparsify_model(cfg, params, 0.9, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params, 2, 32, sparse=sparse)
    cache = init_cache(cfg, 2, 8, device="cpu")
    batch = {"tokens": torch.zeros((2, 1), dtype=torch.int32)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode_step_sparse(cfg, params, sparse, cache, batch)
    logits, _ = decode_step_sparse(cfg, params, sparse, cache, batch,
                                   device="cpu")
    assert logits.shape == (2, 1, cfg.padded_vocab)
    assert ServeEngine(cfg, params, 2, 32, sparse=sparse,
                       device="cpu").device.type == "cpu"


def test_init_params_follows_the_reference_distribution():
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_params
    cfg = get_config("llama7b-espim", reduced=True).replace(n_layers=2)
    gen = torch.Generator().manual_seed(0)
    p = init_params(cfg, gen, device="cpu")
    wq = p["layers"]["attn"]["wq"]
    assert wq.shape == (2, cfg.d_model, cfg.n_heads * cfg.hd)
    assert abs(wq.std().item() - cfg.d_model ** -0.5) < 0.01
    assert abs(p["embed"].std().item() - 0.02) < 0.002
    assert p["embed"].shape == (cfg.padded_vocab, cfg.d_model)
    assert p["lm_head"].shape == (cfg.d_model, cfg.padded_vocab)
    assert torch.equal(p["layers"]["ln1"]["w"], torch.ones(2, cfg.d_model))
    again = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["layers"]["mlp"]["w_down"],
                       p["layers"]["mlp"]["w_down"])


def test_projection_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    import numpy as np

    from repro_torch.core.espim_linear import ESPIMGroupLinear, ESPIMLinear
    from repro_torch.core.sparse_format import pack_ell_chunked
    from repro_torch.kernels import ops

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = np.eye(16, 32, dtype=np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.pack_to_device(pack_ell_chunked(w, chunk_cols=16))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ESPIMLinear.from_dense(w)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ESPIMGroupLinear.from_dense({"a": w, "b": w})
    lin = ESPIMLinear.from_dense(w, device="cpu")
    assert lin.sparse and lin.cols.device.type == "cpu"
    y = lin(torch.ones(32))
    assert torch.equal(y, torch.ones(16))
