"""The port's serving entry points run to their end on the CPU: the
launcher (``python -m repro_torch.launch.serve``, the twin of
``repro.launch.serve``) and the serving example
(``examples/serve_sparse_llm_torch.py``, the twin of
``examples/serve_sparse_llm.py``) with its default quant, with
``--quant int4 --sparse-attn`` and with ``--autotune``.  Without ``--device`` both ask for CUDA
and raise here, as every entry point of the port does."""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve as launch_serve  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _example():
    spec = importlib.util.spec_from_file_location(
        "serve_sparse_llm_torch", ROOT / "examples" /
        "serve_sparse_llm_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_launcher_serves_every_request(capsys):
    stats = launch_serve.main(["--arch", "llama7b-espim", "--reduced",
                               "--requests", "4", "--max-new-tokens", "8",
                               "--device", "cpu"])
    assert stats.requests_completed == 4
    assert stats.tokens_generated == 32
    assert stats.latency_summary()["states"] == {"completed": 4}
    out = capsys.readouterr().out
    assert out.startswith("completed 4 requests, 32 tokens in ")


def test_launcher_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "llama7b-espim", "--reduced"])


@pytest.mark.parametrize("argv", [[], ["--quant", "int4", "--sparse-attn"]],
                         ids=["default", "int4-sparse-attn"])
def test_example_runs_to_its_end(argv, capsys, tmp_path):
    trace = str(tmp_path / "trace.json")
    _example().main(argv + ["--device", "cpu", "--trace", trace])
    out = capsys.readouterr().out
    assert "served 8 requests / 96 tokens" in out
    assert "bits/nnz" in out
    if "--sparse-attn" in argv:
        assert "sparse-attn: whole-model weight bytes/token" in out
    assert "per-request timelines:" in out and "rid 7: completed" in out
    assert Path(trace).stat().st_size > 0


def test_example_autotune_runs_to_its_end(capsys):
    """``--autotune`` searches the layer-0 gate matrix, re-tunes it off
    the warm cache with zero benchmarks, and serves a second engine under
    the tuned chunking with every greedy token equal to the default's."""
    _example().main(["--autotune", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "autotune (256x128 gate matrix, quant=int8, on cpu):" in out
    assert "re-tuned: source=cache (0 benchmarks" in out
    assert "autotuned engine (chunk_cols=" in out
    assert "96/96 greedy tokens equal the default engine's" in out
