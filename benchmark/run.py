"""Run one cell of the benchmark once, on the card(s) of this machine.

    python3 benchmark/run.py --workload embed.tiny.amp --seed 7 --seconds 30 --trace 0

From the root of a checkout. Set-up (imports, the kernels' build on a
checkout's first run, weights and inputs from the seed, warm-up of the
cell's shapes) is timed as ``setup_s``; then the cell's driver measures for
``--seconds`` (``--trace 0``: the end-to-end metrics) or takes the per-layer
readings under the profiler (``--trace 1``). After the window the program's
state is freed and the plain reference checks what the window produced.
The last line of standard output is one JSON object; the numbers compared,
each beside its limit, are the last lines of standard error and the last
key of that object.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
os.environ.setdefault("USE_FLAX", "0")  # keep transformers, if loaded, off JAX

import torch  # noqa: E402

from benchmark import core  # noqa: E402

HOST_SECONDS = 10.0  # the untraced stretch of a traced run (host time, GC, rate)


class Run:
    """What a driver is given: the cell, the seed, the device."""

    def __init__(self, cell: core.Cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)

    @staticmethod
    def note(msg: str) -> None:
        print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: core.Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float | None = None) -> tuple[dict, dict]:
    """One run of ``cell``: ``(result line, checks)``."""
    run = Run(cell, seed, device)
    driver = cell.driver().Driver(run)
    driver.setup()
    _sync(device)
    setup_s = time.perf_counter() - (t_start if t_start is not None else T_START)
    result = {}
    if not trace:
        metrics, attempted, failed = driver.window(seconds)
        metrics["setup_s"] = setup_s
        names = {m["name"]: m["unit"] for m in cell.end_to_end}
        result["metrics"] = {k: {"value": float(v), "unit": names[k]}
                             for k, v in metrics.items() if k in names}
        busy = None
    else:
        main, split, counters, attempted, failed = driver.traced(min(seconds, HOST_SECONDS))
        ctx = types.SimpleNamespace(trace=main, split=split, counters=counters)
        result["metrics"] = core.read_per_layer(cell, ctx)
        busy = (main.busy_s(), main.window_s()) if main.window is not None else None
        if main.window is not None and main.kernels:
            result["breakdown"] = {"device_ops": main.device_ops(),
                                   "idle_gaps": main.idle_gaps()}
    _sync(device)
    dev = torch.device(device)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": cell.entry.get("chips", 1),
                   "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                         if dev.type == "cuda" else 0)}
    if busy is not None:
        device_info["busy_s"], device_info["window_s"] = busy
    driver.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings = driver.check()
    checks = {k: {"value": v, "limit": cell.limits[k]} for k, v in readings.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values()) and failed == 0
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": result["metrics"], "device": device_info}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["checks"] = checks
    return line, checks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = core.Cell(args.workload)
    chips = cell.entry.get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from benchmark import program

    program.use_build_dir()
    line, checks = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0")
    found = core.forbidden_modules()
    if found:
        print(f"the run loaded modules of the JAX side: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in checks.items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILS"
        print(f"check {name} = {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
