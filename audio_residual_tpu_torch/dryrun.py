"""The multi-card dry run, from the JAX package's ``__graft_entry__.py``.

    python -m audio_residual_tpu_torch.dryrun --devices N [--stages 1 2 2b 3 4]
        [--device cpu] [--size tiny]

:func:`entry` is the HTSAT-tiny zero-shot forward on the card.
:func:`dryrun_multichip` runs contrastive training steps over ``n`` ranks,
one process a card joined by NCCL (``device="cpu"``: ``n`` processes on
gloo), in stages:

  1. a data-parallel step on a tiny CLAP;
  2. the flagship data-parallel step: HTSAT-tiny + RoBERTa-base at 480 000
     samples, two clips a rank, 77 tokens;
  2b. the flagship FSDP step (``parallel/fsdp.py``): its loss must equal
     stage 2's, and RoBERTa's word embedding must be sharded before and
     after the update;
  3. an embedding pass of the flagship model, each rank its clips, the
     features gathered: unit norms, the similarity matrix's diagonal;
  4. the flagship step of stage 2 in one process on the whole batch: its
     loss and gradient norm must equal stage 2's.

Each stage's record is one JSON line, printed by rank 0 and flushed as the
stage finishes, ``ok: false`` with the error where it failed; a summary line
follows the stages. ``size="tiny"`` runs stages 2-4 on stage 1's model, for
a rehearsal on the CPU. Where the JAX dry run takes one clip a device, this
one takes two a rank: the CLIP loss of one pair is 0, with no gradient, so
one card would compare zeros.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

__all__ = ["STAGES", "entry", "dryrun_multichip", "main"]

STAGES = ("1", "2", "2b", "3", "4")
PER_RANK = 2  # clips a rank
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)  # FSDP against data parallel (the JAX stage 2b)
N_VS_1_TOL = {"loss": dict(rtol=1e-4, atol=1e-5), "grad_norm": dict(rtol=1e-3, atol=1e-6)}
# stage 1's CLAP (the JAX dry run's, with a vocabulary of 600 so that the word
# embedding, 600 x 32, crosses the shard floor: size "tiny" checks it is sharded)
TINY = dict(clip=24000, tokens=12)


def _tiny_config():
    from audio_residual_tpu_torch.models.clap import CLAPConfig
    from audio_residual_tpu_torch.models.htsat import HTSATConfig
    from audio_residual_tpu_torch.models.roberta import RobertaConfig

    return CLAPConfig(embed_dim=64, joint_embed_shape=32,
                      audio=HTSATConfig(spec_size=64, mel_bins=16, embed_dim=32, depths=(1, 1),
                                        num_heads=(2, 4), clip_samples=TINY["clip"],
                                        num_classes=17),
                      text=RobertaConfig(vocab_size=600, hidden_size=32, num_layers=2,
                                         num_heads=4, intermediate_size=64,
                                         max_position_embeddings=40))


def entry(device=None):
    """``(fn, example_args)``: the zero-shot forward of HTSAT-tiny CLAP
    (random weights, seed 0) on the card (``device="cpu"``: the CPU), on
    two silent 5 s clips."""
    from audio_residual_tpu_torch.data.featurize import featurize_batch
    from audio_residual_tpu_torch.models.clap import CLAPConfig, build_clap_audio, encode_audio

    cfg = CLAPConfig()
    model = build_clap_audio(cfg, seed=0, device=device)
    dev = next(model.parameters()).device

    @torch.no_grad()
    def forward(wav):
        batch = featurize_batch(wav, cfg.audio.clip_samples)
        return encode_audio(model, batch)["normalized"]

    return forward, (torch.zeros(2, 240000, device=dev),)


def _batch(cfg, rows: int, tokens: int, clip: int) -> dict:
    """The global batch of ``rows`` clips from seeds 1 and 2 (the JAX dry
    run's): white noise at 0.1, token ids in [3, vocab) after a 0."""
    wav = (np.random.default_rng(1).standard_normal((rows, clip)) * 0.1).astype(np.float32)
    ids = np.random.default_rng(2).integers(3, min(50000, cfg.text.vocab_size), (rows, tokens))
    ids[:, 0] = 0
    return {"waveform": wav, "input_ids": ids, "attention_mask": np.ones((rows, tokens), np.int64)}


def _step(cfg, batch: dict, *, mesh=None, fsdp_mesh=None, device):
    """One AdamW step (the JAX dry run's optimizer) of a CLAP from seed 0 on
    ``batch`` (this rank's rows): (model, metrics). No randomness: the
    draws of ``n`` ranks' rows would differ from one process's."""
    from audio_residual_tpu_torch.models.clap import build_clap
    from audio_residual_tpu_torch.parallel.fsdp import shard_model
    from audio_residual_tpu_torch.training import train_clap as tc

    model = build_clap(cfg, seed=0, device=device)
    before = None
    if fsdp_mesh is not None:
        shard_model(model, fsdp_mesh)
        before = _placement(model)
    opt = tc.make_optimizer(model, lr=1e-4, warmup=10, total_steps=100)
    state = tc.init_train_state(model, opt)
    step = tc.make_train_step(model, opt, mlp_loss=True, mesh=mesh, fsdp_mesh=fsdp_mesh)
    _, m = step(state, {k: torch.as_tensor(v).to(device) for k, v in batch.items()})
    return model, {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                   "placement_before": before}


def _placement(model) -> dict:
    """RoBERTa's word embedding: its placement and this rank's shard shape."""
    from torch.distributed.tensor import DTensor

    w = model.text_branch.embeddings.word_embeddings.weight
    if not isinstance(w, DTensor):
        return {"sharded": False, "shape": list(w.shape)}
    return {"sharded": any(p.is_shard() for p in w.placements),
            "placements": [str(p) for p in w.placements], "shape": list(w.shape),
            "local_shape": list(w.to_local().shape)}


def _stage(name: str, rank: int, fn) -> dict:
    """Run stage ``name``; rank 0 prints its record as it finishes."""
    t0 = time.perf_counter()
    try:
        record = {"stage": name, **fn(), "ok": True}
    except Exception as e:
        record = {"stage": name, "ok": False, "error": f"{type(e).__name__}: {e}"}
        raise
    finally:
        record["seconds"] = time.perf_counter() - t0
        if rank == 0:
            print("DRYRUN_STAGE " + json.dumps(record), flush=True)
    return record


def _rank_main(rank: int, n: int, port: int, stages: tuple, device_type: str, size: str) -> None:
    import torch.distributed as dist

    from audio_residual_tpu_torch.data.featurize import featurize_batch
    from audio_residual_tpu_torch.models.clap import CLAPConfig, encode_audio
    from audio_residual_tpu_torch.parallel.mesh import data_parallel_mesh, shard_batch

    if device_type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}", world_size=n, rank=rank,
                            device_id=dev if device_type == "cuda" else None)
    try:
        mesh = data_parallel_mesh(n, device=dev)
        tiny = _tiny_config()
        cfg = tiny if size == "tiny" else CLAPConfig()
        shape = (dict(tokens=TINY["tokens"], clip=TINY["clip"]) if size == "tiny"
                 else dict(tokens=77, clip=cfg.audio.clip_samples))
        rows = PER_RANK * n
        glob = _batch(cfg, rows, **shape)
        done = {}

        def stage1():
            b = _batch(tiny, rows, TINY["tokens"], TINY["clip"])
            _, m = _step(tiny, shard_batch(mesh, b), mesh=mesh, device=dev)
            if not np.isfinite(m["loss"]):
                raise AssertionError(f"tiny step loss {m['loss']}")
            return {"name": "tiny_dp_step", "batch": rows, "loss": m["loss"]}

        def stage2():
            _, m = _step(cfg, shard_batch(mesh, glob), mesh=mesh, device=dev)
            if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])):
                raise AssertionError(f"flagship step {m}")
            done["2"] = m
            return {"name": "flagship_dp_step", "batch": rows, "loss": m["loss"],
                    "grad_norm": m["grad_norm"]}

        def stage2b():
            model, m = _step(cfg, shard_batch(mesh, glob), fsdp_mesh=mesh, device=dev)
            after = _placement(model)
            if not (m["placement_before"]["sharded"] and after["sharded"]):
                raise AssertionError(f"word embedding not sharded: {m['placement_before']}, "
                                     f"{after}")
            np.testing.assert_allclose(m["loss"], done["2"]["loss"], **LOSS_TOL)
            return {"name": "flagship_fsdp_step", "loss": m["loss"],
                    "grad_norm": m["grad_norm"], "dp_loss": done["2"]["loss"],
                    "dp_vs_fsdp_dloss": abs(m["loss"] - done["2"]["loss"]),
                    "word_embedding_before": m["placement_before"],
                    "word_embedding_after": after, "tol": LOSS_TOL}

        def stage3():
            from audio_residual_tpu_torch.models.clap import build_clap

            model = build_clap(cfg, seed=0, device=dev)
            wav = (np.random.default_rng(3).standard_normal((rows, shape["clip"] // 2)) * 0.1
                   ).astype(np.float32)
            with torch.no_grad():
                local = shard_batch(mesh, {"w": wav})["w"]
                emb = encode_audio(model, featurize_batch(local, cfg.audio.clip_samples))[
                    "normalized"]
                parts = [torch.empty_like(emb) for _ in range(n)]
                dist.all_gather(parts, emb.contiguous())
                emb = torch.cat(parts)
            norms = emb.norm(dim=-1).double().cpu().numpy()
            np.testing.assert_allclose(norms, 1.0, atol=1e-5)
            sims = (emb @ emb.T).double().cpu().numpy()
            return {"name": "sharded_eval", "batch": rows, "embed_dim": int(emb.shape[-1]),
                    "sim_diag_mean": float(np.diagonal(sims).mean())}

        def stage4():
            rec = {"name": "n_vs_1_equivalence", "loss_n": done["2"]["loss"],
                   "grad_norm_n": done["2"]["grad_norm"]}
            if rank == 0:
                _, m = _step(cfg, glob, device=dev)
                for k in ("loss", "grad_norm"):
                    np.testing.assert_allclose(done["2"][k], m[k], **N_VS_1_TOL[k])
                rec.update(loss_1=m["loss"], grad_norm_1=m["grad_norm"], tol=N_VS_1_TOL)
            dist.barrier()
            return rec

        run = {"1": stage1, "2": stage2, "2b": stage2b, "3": stage3, "4": stage4}
        for name in stages:
            _stage(name, rank, run[name])
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, stages=STAGES, *, device: str | None = None,
                     size: str = "flagship", timeout_s: float = 3600.0) -> dict:
    """Run ``stages`` (in :data:`STAGES`' order) over ``n_devices`` ranks,
    one process each: the card of its rank and NCCL, or, with
    ``device="cpu"``, gloo on the CPU. Prints each stage's record as it
    finishes (rank 0), then the summary, and returns the summary; raises
    when a process fails or outlives ``timeout_s``."""
    stages = tuple(s for s in STAGES if s in set(stages))
    if ("2b" in stages or "4" in stages) and "2" not in stages:
        raise ValueError("stages 2b and 4 are held against stage 2: run it too")
    device_type = "cpu" if device == "cpu" else "cuda"
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' to run on gloo")
        if n_devices > torch.cuda.device_count():
            raise ValueError(f"{n_devices} ranks need {n_devices} cards, one each; "
                             f"this machine has {torch.cuda.device_count()}")
    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, n_devices, port, stages, device_type, size))
             for r in range(n_devices)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(max(timeout_s - (time.perf_counter() - t0), 1.0))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    codes = [p.exitcode for p in procs]
    summary = {"dryrun": {"devices": n_devices, "device": device_type, "size": size,
                          "stages": list(stages), "exit_codes": codes,
                          "timed_out": bool(alive), "seconds": time.perf_counter() - t0},
               "ok": not alive and all(c == 0 for c in codes)}
    print("DRYRUN " + json.dumps(summary), flush=True)
    if not summary["ok"]:
        raise RuntimeError(f"dryrun_multichip({n_devices}) failed: exit codes {codes}"
                           + (f", killed after {timeout_s} s" if alive else ""))
    return summary


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks, one a card (default: every card; with --device cpu, 2)")
    ap.add_argument("--stages", nargs="+", default=list(STAGES), choices=STAGES)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--size", choices=("flagship", "tiny"), default="flagship")
    args = ap.parse_args(argv)
    device = "cpu" if args.device == "cpu" else None
    n = args.devices or (2 if device == "cpu" else torch.cuda.device_count())
    fn, example = entry(device)
    out = fn(*example)
    print("DRYRUN_ENTRY " + json.dumps({"shape": list(out.shape), "device": str(out.device),
                                        "finite": bool(torch.isfinite(out).all())}), flush=True)
    dryrun_multichip(n, args.stages, device=device, size=args.size)
    return 0


if __name__ == "__main__":
    sys.exit(main())
