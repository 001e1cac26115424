"""``BENCHMARK.json`` against the benchmark's contract, and every file it
names found by name."""
from __future__ import annotations

import json

import pytest

from perfbench.harness.manifest import (BENCH_DIR, NAME_RE, ROOT, UNIT_RE,
                                        Cell, load_manifest, load_reader)

MAN = load_manifest()
CELLS = [w["name"] for w in MAN["workloads"]]
METRICS = MAN["end_to_end"] + MAN["per_layer"]
TEXT_LIMIT = 200


def _one_line(s: str) -> bool:
    return 1 <= len(s) <= TEXT_LIMIT and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"][:2] == ["python3", "perfbench/run.py"]
    assert MAN["paths"] == ["perfbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units_use_the_allowed_characters():
    names = ([c["name"] for c in MAN["configs"]] + CELLS
             + [m["name"] for m in METRICS]
             + [w["config"] for w in MAN["workloads"]]
             + [w["traffic"] for w in MAN["workloads"]]
             + [k for c in MAN["configs"] for k in c["reduced"]])
    for n in names:
        assert NAME_RE.match(n), n
    for m in METRICS:
        assert UNIT_RE.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for group in (MAN["configs"], MAN["workloads"], METRICS):
        assert len({x["name"] for x in group}) == len(group)


def test_entries_have_just_their_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _one_line(c["why"]) and _one_line(c["source"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _one_line(w["why"])
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert _one_line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_reports_what_it_must():
    e2e = {m["name"] for m in MAN["end_to_end"]}
    assert "setup_s" in e2e
    for name in CELLS:
        cell = Cell(name)
        have = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in have and len(have) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in have


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_are_found_by_name(name):
    cell = Cell(name)
    assert cell.config["name"] == cell.entry["config"]
    assert (BENCH_DIR / "traffic" / f"{cell.mix_name}.json").is_file()
    assert cell.limits["max_logit_gap"] is not None
    assert cell.limits["sample_requests"] >= 1
    assert set(cell.limits["control"]) <= {"program_quant", "reference_code"}
    assert (BENCH_DIR / "reference" / f"{cell.config['family']}.py").is_file()
    assert (BENCH_DIR / "traffic" / "loops" / f"{cell.mix['loop']}.py"
            ).is_file()
    assert callable(cell.family.forward_logits) and cell.loop is not None
    for m in cell.end_to_end + cell.per_layer:
        assert callable(load_reader(m["name"]))


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda c: c["name"])
def test_config_file_states_its_cut(entry):
    path = ROOT / entry["file"]
    assert path.parts[len(ROOT.parts)] == "perfbench"
    cfg = json.loads(path.read_text())
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert sorted(cfg["reduced"]) == sorted(entry["reduced"])
    for key in entry["reduced"]:
        assert cfg["model"][key] != cfg["published"][key]
    assert len({c["file"] for c in MAN["configs"]}) == len(MAN["configs"])


def test_program_config_matches_each_file():
    from repro_torch.configs.registry import get_config

    from perfbench.harness.cell import program_config
    from perfbench.harness.plugins import load_module
    for entry in MAN["configs"]:
        cfg = json.loads((ROOT / entry["file"]).read_text())
        family = load_module("reference", cfg["family"])
        pc = program_config(get_config, cfg, None, family)
        assert pc.n_layers == cfg["model"]["num_hidden_layers"]
        assert pc.norm_eps == cfg["model"]["rms_norm_eps"]
        wrong = json.loads(json.dumps(cfg))
        wrong["model"]["residual_multiplier"] = 0.22
        with pytest.raises(ValueError, match="residual_multiplier"):
            program_config(get_config, wrong, None, family)
