"""Minimal embed-audio/text example, from
``audio_residual_tpu/training/infer_demo.py`` (the reference's
`training/infer_demo.py`), on the port's ``CLAPModule``.

Run: ``python -m audio_residual_tpu_torch.training.infer_demo [--ckpt path]``
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None, *, device=None, tokenizer=None) -> dict:
    """The demo on the card (``device="cpu"``: the plain versions on the
    CPU); returns the embeddings and their similarities."""
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", default=None, help="torch CLAP checkpoint to load")
    p.add_argument("--amodel", default="HTSAT-tiny")
    p.add_argument("--files", nargs="*", default=None, help="audio files to embed")
    args = p.parse_args(argv)

    from audio_residual_tpu_torch.module import CLAPModule

    m = CLAPModule(amodel=args.amodel, tokenizer=tokenizer, device=device)
    if args.ckpt:
        m.load_ckpt(args.ckpt)

    if args.files:
        audio_embed = m.get_audio_embedding_from_filelist(args.files)
    else:
        rng = np.random.default_rng(0)
        wav = (rng.standard_normal((2, m.cfg.audio.clip_samples // 2)) * 0.1).astype(np.float32)
        audio_embed = m.get_audio_embedding_from_data(wav)
    print("audio embeddings:", audio_embed.shape)

    texts = ["a dog barking", "rain falling on a roof"]
    text_embed = m.get_text_embedding(texts)
    print("text embeddings:", text_embed.shape)
    sims = audio_embed @ text_embed.T
    print("similarities:\n", sims)
    return {"audio": audio_embed, "text": text_embed, "similarities": sims}


if __name__ == "__main__":
    main()
