"""A configuration, a traffic mix, a cell and a per-layer metric added as
new files are found by name; no existing file is edited."""

from __future__ import annotations

import json
import shutil
import time

from inrbench import harness

from conftest import ROOT


def test_new_files_found_by_name(tmp_path):
    pkg = tmp_path / "bench"
    for d in ("traffic", "cells", "metrics", "configs"):
        (pkg / d).mkdir(parents=True)
    shutil.copytree(ROOT / "inrbench" / "models", pkg / "models")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    # a configuration of its own: a narrower SIREN, only as a file
    cfg = json.loads((ROOT / "inrbench" / "configs"
                      / "siren-256x3.json").read_text())
    cfg.update(name="siren-tiny", hidden_features=16, hidden_layers=2)
    (pkg / "configs" / "siren-tiny.json").write_text(json.dumps(cfg))
    spec["configs"].append({"name": "siren-tiny", "source": "test",
                            "file": str(pkg / "configs" / "siren-tiny.json"),
                            "reduced": [], "why": "test"})
    (pkg / "traffic" / "edit-o1-tiny.json").write_text(json.dumps({
        "loop": "closed", "order": 1, "grid": [8, 8], "max_requests": 100000,
        "warm_requests": 1, "check_requests": 2, "check_block": 32}))
    name = "siren-tiny.edit-o1-tiny"
    (pkg / "cells" / f"{name}.json").write_text(json.dumps(
        {"limits": {"max_scaled_err": 1e-4}}))
    (pkg / "metrics" / "rows_seen.tiny.py").write_text(
        "def read(ctx):\n    return float(ctx.window.rows)\n")
    spec["workloads"].append({"name": name, "config": "siren-tiny",
                              "traffic": "edit-o1-tiny", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"] == "rows_per_s":
            m["workloads"].append(name)
    spec["per_layer"].append({"name": "rows_seen.tiny", "unit": "rows",
                              "better": "higher", "source": "host_clock",
                              "layer": "client", "moves": "rows_per_s",
                              "workloads": [name]})
    root = tmp_path / "checkout"
    root.mkdir()
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = harness.find_cell(root, name, pkg)
    assert cell.config["hidden_features"] == 16
    assert [m["name"] for m in cell.end_to_end] == ["rows_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["rows_seen.tiny"]
    for trace in (False, True):
        out = harness.run_cell(root, name, 5, 0.2, trace, device="cpu",
                               t_start=time.perf_counter(), pkg=pkg,
                               cell=cell, log=lambda m: None)
        res = out["result"]
        assert res["correct"] is True
        assert list(res)[-1] == "checks"
        if trace:
            assert res["metrics"]["rows_seen.tiny"]["value"] > 0
        else:
            assert set(res["metrics"]) == {"rows_per_s", "setup_s"}


def test_benchmark_json_names_every_file():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in spec["workloads"]:
        cell = harness.find_cell(ROOT, w["name"])
        assert cell.limits
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert (ROOT / "inrbench" / "metrics"
                    / f"{m['name']}.py").is_file()
            assert m["moves"] in {e["name"] for e in cell.end_to_end}
