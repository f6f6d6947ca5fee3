"""A later change adds a configuration, a cell and a per-layer metric as
files of their own; the harness finds them by name, and no file that was
there changes."""

from __future__ import annotations

import hashlib
import json
import shutil

import torch

from benchmark import core
from benchmark import run as bench_run
from benchmark.tests import bench_tiny as tiny


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_new_config_cell_and_metric_are_found(tmp_path, monkeypatch):
    bench = tmp_path / "benchmark"
    shutil.copytree(core.HERE, bench, ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((core.ROOT / "BENCHMARK.json").read_text())
    before = _digests(bench)

    # the new files
    (bench / "configs" / "htsat-test.json").write_text(json.dumps(tiny.CONFIG))
    traffic = {**json.loads((bench / "traffic" / "embed.amp.json").read_text()),
               **tiny.TRAFFIC["embed"]}
    (bench / "traffic" / "embed.test.json").write_text(json.dumps(traffic))
    (bench / "limits" / "embed.test.amp.json").write_text(json.dumps({"embed_gap": 0.03}))
    (bench / "metrics" / "batches_seen.embed.py").write_text(
        '"""Batches of the untraced stretch."""\n\n\ndef read(ctx):\n'
        '    return ctx.counters.get("batches")\n')
    # the new entries
    spec["configs"].append({"name": "htsat-test", "source": "https://example.org/test",
                            "file": "benchmark/configs/htsat-test.json", "reduced": [],
                            "why": "test"})
    spec["workloads"].append({"name": "embed.test.amp", "config": "htsat-test",
                              "traffic": "embed.test", "chips": 1, "why": "test"})
    for m in spec["end_to_end"]:
        if "embed.tiny.amp" in m.get("workloads", []):
            m["workloads"].append("embed.test.amp")
    spec["per_layer"].append({"name": "batches_seen.embed", "unit": "batches",
                              "better": "higher", "source": "program_counter",
                              "layer": "entry", "moves": "embed_clips_per_s",
                              "workloads": ["embed.test.amp"]})

    monkeypatch.setattr(core, "HERE", bench)
    monkeypatch.setattr(core, "ROOT", tmp_path)
    cell = core.Cell("embed.test.amp", spec)
    assert cell.config["name"] == "htsat-test"
    assert cell.traffic["batch"] == tiny.TRAFFIC["embed"]["batch"]
    assert [m["name"] for m in cell.per_layer] == ["batches_seen.embed"]
    assert {m["name"] for m in cell.end_to_end} == {"embed_clips_per_s", "embed_p95_ms",
                                                    "setup_s"}

    line, _ = bench_run.run_cell(cell, 12345, 0.2, True, torch.device("cpu"), t_start=0.0)
    assert line["correct"]
    assert line["metrics"]["batches_seen.embed"]["value"] >= 1

    after = _digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before
