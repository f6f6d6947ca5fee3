"""Experiment driver 1: analyze CLAP attention representations.

Port of ``examples/1_analyze_clap_attention.py``, the script form of the
reference's `1_Analyze_CLAP_Attention.ipynb`: build CLAP, stream a fold of
the dataset (already on disk, in its own layout) through the encoder
collecting per-(layer, head) attention maps, fit PCA per head on the card,
save the reference-format CSV, and report intrinsic-dimensionality findings.

Run: ``python -m audio_residual_tpu_torch.examples.analyze_clap_attention --ckpt 630k-audioset-best.pt``
"""

from __future__ import annotations

import argparse

from audio_residual_tpu_torch.data.datasets import get_fold_loaders
from audio_residual_tpu_torch.data.featurize import featurize_batch
from audio_residual_tpu_torch.models.clap import encode_audio
from audio_residual_tpu_torch.module import CLAPModule
from audio_residual_tpu_torch.ops.quantize import quantize_roundtrip
from audio_residual_tpu_torch.residual import analyze


def main(argv=None, *, device=None) -> dict:
    """Returns ``{"csv": path, "heads": {(layer, head): {"intrinsic_dim",
    "participation_ratio"}}}``, what it prints."""
    from audio_residual_tpu_torch.utils.cache import enable_compile_cache

    enable_compile_cache()

    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", default=None)
    p.add_argument("--dataset", default="ESC50")
    p.add_argument("--root", default=".")
    p.add_argument("--fold", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-batches", type=int, default=None)
    p.add_argument("--save-dir", default="pca_results")
    args = p.parse_args(argv)

    module = CLAPModule(device=device)
    if args.ckpt:
        module.load_ckpt(args.ckpt)
    cfg = module.cfg

    def encode_with_taps(wav):
        w = quantize_roundtrip(wav)
        batch = featurize_batch(w, cfg.audio.clip_samples)
        return encode_audio(module.model, batch, taps=("attention",))

    _, val_batches = get_fold_loaders(args.dataset, args.root, args.batch_size)[args.fold]

    results = analyze.run_pca(
        encode_with_taps,
        (wav for wav, _ in val_batches()),
        num_layers=cfg.audio.num_layers,
        num_heads=cfg.audio.num_heads,
        max_batches=args.max_batches,
        window=cfg.audio.window_size,
        device=module.device,
    )
    csv_path = analyze.save_pca_results_on_file(args.save_dir, args.dataset, args.fold, results)
    print("saved:", csv_path)
    heads = {}
    for (layer, head), r in sorted(results.items()):
        idim = analyze.intrinsic_dim(r["explained_variance_ratio"], threshold=0.90)
        pr = analyze.participation_ratio(r["explained_variance"])
        heads[(layer, head)] = {"intrinsic_dim": idim, "participation_ratio": pr}
        print(f"layer {layer} head {head}: intrinsic_dim={idim} participation_ratio={pr:.1f}")
    return {"csv": csv_path, "heads": heads}


if __name__ == "__main__":
    main()
