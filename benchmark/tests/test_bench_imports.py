"""What the benchmark runs loads nothing of the JAX side, and the plain
reference loads nothing of the program: each module's top-level name (the
part before the first dot) compared whole, in a fresh interpreter."""

from __future__ import annotations

import json
import subprocess
import sys

from benchmark.core import FORBIDDEN, ROOT

RUN_A_CELL = """
import json, sys, torch
sys.path.insert(0, {root!r})
from benchmark.tests import bench_tiny as tiny
from benchmark import run as bench_run
for name in ("embed.tiny.amp", "lambda.tiny.f32", "analysis.tiny.f32"):
    bench_run.run_cell(tiny.cell(name), 3, 0.1, False, torch.device("cpu"), t_start=0.0)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

LOAD_THE_REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import benchmark.reference.htsat, benchmark.reference.pca, benchmark.reference.residual_train
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600, cwd=ROOT, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_nothing_of_the_jax_side():
    loaded = _top_level(RUN_A_CELL)
    assert "audio_residual_tpu_torch" in loaded  # the program ran
    assert not loaded & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    loaded = _top_level(LOAD_THE_REFERENCE)
    assert not loaded & {"audio_residual_tpu_torch", *FORBIDDEN}
