"""What every cell shares: the cell's files found by name, the card's peaks,
the readers of the per-layer metrics, and the check that the run loaded
nothing of the JAX package.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration (``configs[].file``) and a traffic mix
(``benchmark/traffic/<traffic>.json``), whose ``driver`` names the loop in
``benchmark/drivers/<driver>.py``; the limits of its correctness check are
``benchmark/limits/<cell>.json``, and a per-layer metric is read by
``benchmark/metrics/<metric>.py``. Adding any of these is adding a file.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path

__all__ = ["HERE", "ROOT", "PEAK_FLOPS", "PEAK_BYTES_S", "Cell", "load_module",
           "forbidden_modules", "read_per_layer"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# One H100 SXM's published dense bf16 rate and HBM3 bandwidth. Every share
# divides by these, whatever precision a cell runs, so a share moves only
# with time and never with a change of route.
PEAK_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12

FORBIDDEN = ("jax", "jaxlib", "flax", "audio_residual_tpu")


def load_module(path: Path, name: str):
    """Import the file ``path`` as module ``name`` (file names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of ``workloads``, with its configuration, traffic, limits
    and metrics read from their files."""

    def __init__(self, name: str, spec: dict | None = None):
        spec = spec if spec is not None else json.loads((ROOT / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        configs = {c["name"]: c for c in spec["configs"]}
        self.config = json.loads((ROOT / configs[self.entry["config"]]["file"]).read_text())
        self.traffic = json.loads((HERE / "traffic" / f"{self.entry['traffic']}.json").read_text())
        self.limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
        self.end_to_end = [m for m in spec["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in spec["per_layer"] if name in m.get("workloads", [name])]

    def driver(self):
        path = HERE / "drivers" / f"{self.traffic['driver']}.py"
        return load_module(path, f"benchmark_driver_{self.traffic['driver']}")


def read_per_layer(cell: Cell, ctx) -> dict:
    """Each per-layer metric of the cell by its reader; a reader that finds
    nothing returns None and the metric is left out."""
    out = {}
    for m in cell.per_layer:
        reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                             "benchmark_metric_" + m["name"].replace(".", "_"))
        value = reader.read(ctx)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of the JAX side's."""
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN})
