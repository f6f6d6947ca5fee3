"""Time ``data/datasets.py::resample_poly`` against the direct form of the
same function, on the host's CPU.

    python -m audio_residual_tpu_torch.tools.time_resample [seconds] [sr_in] [sr_out]

The direct form is the JAX package's formulation, written out here: stuff
``up - 1`` zeros between samples, ``np.convolve(mode="same")`` with the
windowed sinc, keep every ``down``-th sample. The port's polyphase form sums
only the nonzero stuffed samples of the kept outputs. Prints one line: the
direct form on a short input (default 0.1 s of 44.1 kHz audio to 48 kHz),
its cost scaled to a 5 s ESC-50 clip and to ESC-50's 2000 clips, the
polyphase form on the same input and on a 5 s clip, and the largest
difference of the two.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from audio_residual_tpu_torch.data.datasets import _resample_filter, resample_poly


def direct(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    g = np.gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    y = np.zeros(len(x) * up, dtype=np.float64)
    y[::up] = x
    return np.convolve(y, _resample_filter(up, down), mode="same")[::down].astype(np.float32)


def _seconds(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def main(argv) -> int:
    seconds = float(argv[0]) if argv else 0.1
    sr_in = int(argv[1]) if len(argv) > 1 else 44100
    sr_out = int(argv[2]) if len(argv) > 2 else 48000
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(int(sr_in * seconds)) * 0.1).astype(np.float32)
    clip = (rng.standard_normal(5 * sr_in) * 0.1).astype(np.float32)
    d_s = _seconds(lambda: direct(x, sr_in, sr_out))
    p_s = _seconds(lambda: resample_poly(x, sr_in, sr_out))
    clip_s = _seconds(lambda: resample_poly(clip, sr_in, sr_out))
    diff = float(np.abs(direct(x, sr_in, sr_out) - resample_poly(x, sr_in, sr_out)).max())
    print(json.dumps({"input_s": seconds, "sr_in": sr_in, "sr_out": sr_out,
                      "direct_s": d_s, "direct_5s_clip_s_scaled": d_s * 5 / seconds,
                      "direct_esc50_h_scaled": d_s * 5 / seconds * 2000 / 3600,
                      "polyphase_s": p_s, "polyphase_5s_clip_s": clip_s,
                      "polyphase_esc50_s_scaled": clip_s * 2000, "max_abs_diff": diff}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
