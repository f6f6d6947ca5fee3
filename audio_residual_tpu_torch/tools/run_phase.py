"""Run chosen phases of ``chip_smoke.py`` on the card, after the build.

    python -m audio_residual_tpu_torch.tools.run_phase contrastive [clap ...]

Each name is a ``phase_<name>`` function of ``chip_smoke.py`` that takes
``(dev, card)``. For trying a phase alone; ``chip_smoke.py`` runs them all.
"""

from __future__ import annotations

import subprocess
import sys


def main(names) -> int:
    import torch

    import chip_smoke
    from audio_residual_tpu_torch.ops.cuda import build

    if not torch.cuda.is_available():
        print("run_phase: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    dev = torch.device("cuda", 0)
    for name in names:
        getattr(chip_smoke, f"phase_{name}")(dev, card)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
