"""Tar shard validator: ``audio_residual_tpu/utils/check_tars.py``.

Reference: `CLAP/src/tests/check_tars.py:16-120`: iterate every tar shard,
decode each audio + json pair, move corrupt tars into a sibling directory,
and rewrite ``sizes.json`` to match the shards that remain.
"""

from __future__ import annotations

import json
import os
import shutil

from audio_residual_tpu_torch.data.shards import iter_tar_samples

__all__ = ["check_tars"]


def check_tars(
    shard_dir: str,
    *,
    quarantine_dir: str | None = None,
    rewrite_sizes: bool = True,
    verbose: bool = True,
) -> dict:
    """Validate every ``*.tar`` under ``shard_dir``. Returns
    ``{ok: {tar: n_samples}, bad: [tar, ...]}``; corrupt tars are moved to
    ``quarantine_dir`` (default ``<shard_dir>_invalid``)."""
    quarantine_dir = quarantine_dir or shard_dir.rstrip("/") + "_invalid"
    ok: dict[str, int] = {}
    bad: list[str] = []
    for name in sorted(os.listdir(shard_dir)):
        if not name.endswith(".tar"):
            continue
        path = os.path.join(shard_dir, name)
        n = 0
        failed = False

        def strict_handler(exn):
            nonlocal failed
            failed = True
            return True  # swallow but mark

        try:
            for _ in iter_tar_samples(path, handler=strict_handler):
                n += 1
        except Exception:
            failed = True
        if failed or n == 0:
            bad.append(name)
            os.makedirs(quarantine_dir, exist_ok=True)
            shutil.move(path, os.path.join(quarantine_dir, name))
            if verbose:
                print(f"quarantined {name}")
        else:
            ok[name] = n
            if verbose:
                print(f"{name}: {n} samples")
    if rewrite_sizes:
        with open(os.path.join(shard_dir, "sizes.json"), "w") as f:
            json.dump(ok, f, indent=2)
    return {"ok": ok, "bad": bad}
