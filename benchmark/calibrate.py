"""Readings that set a cell's correctness limits: the numbers the check
compares, for the program over many seeds, and for the control, the
reference put in the program's place at the precision below the cell's
(or with a fault planted), over some of them. All seeds run in one process.

    python3 benchmark/calibrate.py --workload embed.tiny.amp --seeds 1,2,3 \\
        --control fp8 --control-seeds 1,2,3 --seconds 2

Each seed prints one JSON line; the last line gives, per number, the
largest program reading and the smallest control reading.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from benchmark import core, program  # noqa: E402
from benchmark.run import Run  # noqa: E402


def readings(cell: core.Cell, seed: int, seconds: float, device, control: str | None,
             fault: str | None) -> dict:
    driver = cell.driver().Driver(Run(cell, seed, device))
    driver.setup()
    driver.window(seconds)
    driver.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out = {"seed": seed, "program": driver.check()}
    if control:
        if fault:
            driver.substitute(control, fault=fault)
        else:
            driver.substitute(control)
        out["control"] = driver.check()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", default=None)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", default=None)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    cell = core.Cell(args.workload)
    if not torch.cuda.is_available():
        print("calibration reads the card: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    program.use_build_dir()
    device = torch.device("cuda:0")
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    lows, highs = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        r = readings(cell, seed, args.seconds, device,
                     args.control if seed in controls else None, args.fault)
        print(json.dumps(r), flush=True)
        for k, v in r["program"].items():
            lows[k] = max(lows.get(k, 0.0), v)
        for k, v in r.get("control", {}).items():
            highs[k] = min(highs.get(k, float("inf")), v)
        gc.collect()
    print(json.dumps({"workload": cell.name, "lower": lows, "upper": highs,
                      "control": args.control, "fault": args.fault}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
