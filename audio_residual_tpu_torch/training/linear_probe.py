"""Linear probe on the frozen CLAP audio embedding.

Port of ``audio_residual_tpu/training/linear_probe.py`` (the reference's
``HTSATLinearClassifier``, `src/linear.py:9-124`, and the vendored
``LinearProbe``'s head and output activations,
`clap_module/linear_probe.py:7-63`), with its semantics, except that the
model (a :class:`~audio_residual_tpu_torch.models.clap.CLAPAudio`, which
carries its config) takes the place of ``params`` and ``cfg``, and a seed
takes the place of the JAX key.

The frozen regime embeds each split once (:func:`embed_dataset`) and trains
the head on the ``[N, 512]`` embeddings. Training is AdamW on the head
(``torch.optim.AdamW(lr, weight_decay=0.01)``: its decoupled decay
``p -= lr * (wd * p + adam_step)`` is ``optax.adamw``'s); shuffles and
mixup coefficients come from ``np.random.default_rng(0)`` as in the JAX
package, so both see the same batches.
"""

from __future__ import annotations

import logging
import os
from typing import Iterable

import numpy as np
import torch
import torch.nn.functional as F

from audio_residual_tpu_torch import resolve_device
from audio_residual_tpu_torch.data.featurize import featurize_batch, fusion_batch, mel_audio_cfg
from audio_residual_tpu_torch.models.clap import CLAPAudio, encode_audio
from audio_residual_tpu_torch.ops.fusion import fusion_kind
from audio_residual_tpu_torch.ops.quantize import quantize_roundtrip
from audio_residual_tpu_torch.training.losses import lp_loss
from audio_residual_tpu_torch.utils.misc import do_mixup, get_mix_lambda

__all__ = ["init_linear_head", "head_apply", "embed_dataset", "train_linear_head",
           "eval_linear_head", "train_and_eval_linear_head"]


def init_linear_head(seed: int, in_dim: int = 512, n_classes: int = 50, mlp: bool = False,
                     device: str | torch.device | None = None) -> dict:
    """Kaiming-normal weight, zero bias (`src/linear.py:19-21`), drawn from a
    ``torch.Generator`` seeded by ``seed``; with ``mlp`` a Linear-ReLU-Linear
    head (the ``--lp-mlp`` variant). ``{"out": {"kernel": [in, n], "bias":
    [n]}}`` (and ``"hidden"``), the JAX package's layout, on ``device`` (the
    card unless told)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    std = np.sqrt(2.0 / in_dim)

    def layer(n_out):
        return {"kernel": (std * torch.randn(in_dim, n_out, generator=gen)).to(dev),
                "bias": torch.zeros(n_out, device=dev)}

    if not mlp:
        return {"out": layer(n_classes)}
    return {"hidden": layer(in_dim), "out": layer(n_classes)}


def head_apply(head: dict, x: torch.Tensor, act: str = "None") -> torch.Tensor:
    """Probe head forward; ``act`` is the ``--lp-act`` output activation
    applied before the loss (`clap_module/linear_probe.py:32-43,60-63`).

    ``prelu`` raises: the reference builds ``nn.PReLU(num_parameters=in_ch)``
    (512 weights) but applies it to the ``out_ch``-sized head output, a
    shape crash for any class count != 512, so there is no working semantics
    to match."""
    if "hidden" in head:
        x = torch.relu(x @ head["hidden"]["kernel"] + head["hidden"]["bias"])
    x = x @ head["out"]["kernel"] + head["out"]["bias"]
    if act in (None, "None"):
        return x
    if act == "relu":
        return torch.relu(x)
    if act == "elu":
        return F.elu(x)
    if act == "softmax":
        return torch.softmax(x, dim=-1)
    if act == "sigmoid":
        return torch.sigmoid(x)
    if act == "prelu":
        raise NotImplementedError(
            "--lp-act prelu: the reference's PReLU(num_parameters=in_ch) "
            "cannot be applied to the [B, n_classes] head output "
            "(clap_module/linear_probe.py:38-39 shape bug)"
        )
    raise ValueError(f"unknown --lp-act {act!r}")


def _device(model: CLAPAudio) -> torch.device:
    return model.audio_projection[0].weight.device


def embed_dataset(model: CLAPAudio, batches: Iterable, *, max_len: int = 480000,
                  quantize: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """Frozen-encoder embeddings of a whole split, computed once:
    ``(normalized [N, 512], labels [N])`` as numpy. ``batches`` yield
    ``(wav [B, T], labels [B])``; crops of clips over ``max_len`` come from a
    generator seeded 0, as in ``train_residual``'s evaluation. A fusion model
    takes each clip's ``mel_fusion`` (``data/featurize.py::fusion_batch``,
    its chunks from ``np.random.default_rng(0)``), as
    ``CLAPModule(enable_fusion=True)`` builds it; the JAX package sends it the
    waveform, which a 2-D fusion model cannot embed (ROADMAP Queue 3)."""
    device = _device(model)
    audio = model.cfg.audio
    chunks = (np.random.default_rng(0)
              if fusion_kind(audio.enable_fusion, audio.fusion_type) else None)
    feats, labels = [], []
    with torch.no_grad():
        for wav, y in batches:
            wav = torch.as_tensor(wav, device=device, dtype=torch.float32)
            if quantize:
                wav = quantize_roundtrip(wav)
            if chunks is not None:
                batch = fusion_batch(list(wav.cpu().numpy()), max_len, mel_audio_cfg(audio),
                                     chunks, device)
            else:
                batch = featurize_batch(wav, max_len,
                                        generator=torch.Generator().manual_seed(0))
            feats.append(encode_audio(model, batch)["normalized"].cpu().numpy())
            labels.append(np.asarray(torch.as_tensor(y).cpu()))
    return np.concatenate(feats), np.concatenate(labels)


def train_linear_head(
    seed: int,
    feats: np.ndarray,
    labels: np.ndarray,
    n_classes: int,
    *,
    epochs: int = 20,
    lr: float = 1e-3,
    weight_decay: float = 0.01,
    batch_size: int = 64,
    mlp: bool = False,
    loss_kind: str = "ce",
    mixup_alpha: float = 0.0,
    act: str = "None",
    device: str | torch.device | None = None,
) -> tuple[dict, list[dict]]:
    """AdamW on the head only (`src/linear.py:68-74`), on ``device`` (the
    card unless told). Returns the trained head (detached) and the
    per-epoch history.

    ``mixup_alpha`` > 0 enables the ``--mixup`` augmentation of the
    reference LP loop (`lp_train.py:86-91`): labels are softened with
    ``do_mixup`` as the reference does, and the input side is mixed on the
    cached embeddings (manifold mixup), since the frozen encoder's outputs
    are computed once."""
    dev = resolve_device(device)
    if mixup_alpha:
        logging.warning(
            "--mixup on the linear probe mixes cached EMBEDDINGS "
            "(manifold mixup), not waveforms like the reference "
            "(lp_train.py:86-91): label softening is exact, input-side "
            "results are not numerically comparable to the reference run"
        )
    head = init_linear_head(seed, feats.shape[-1], n_classes, mlp=mlp, device=dev)
    leaves = [t.requires_grad_(True) for layer in head.values() for t in layer.values()]
    optimizer = torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=weight_decay)
    n = feats.shape[0]
    rng = np.random.default_rng(0)
    labels_soft = labels
    if mixup_alpha and labels.ndim == 1:  # int labels -> one-hot for mixing
        labels_soft = np.eye(n_classes, dtype=np.float32)[labels]
    history = []
    for e in range(epochs):
        perm = rng.permutation(n)
        total = 0.0
        for i in range(0, n, batch_size):
            idx = perm[i : i + batch_size]
            x = torch.as_tensor(feats[idx], device=dev)
            y = torch.as_tensor(labels_soft[idx], device=dev)
            if mixup_alpha:
                lam = torch.as_tensor(get_mix_lambda(mixup_alpha, len(idx), rng), device=dev)
                x = do_mixup(x, lam)
                y = do_mixup(y, lam)
            optimizer.zero_grad(set_to_none=True)
            loss = lp_loss(head_apply(head, x, act), y, loss_kind)
            loss.backward()
            optimizer.step()
            total += float(loss.detach()) * len(idx)
        history.append({"epoch": e, "train_loss": total / n})
    return {k: {p: t.detach() for p, t in layer.items()} for k, layer in head.items()}, history


def eval_linear_head(head: dict, feats: np.ndarray, labels: np.ndarray, act: str = "None"):
    """-> (predictions, targets, softmax similarities) (`src/linear.py:97-124`)."""
    dev = head["out"]["kernel"].device
    with torch.no_grad():
        logits = head_apply(head, torch.as_tensor(feats, device=dev), act)
        sims = torch.softmax(logits, dim=-1).cpu().numpy()
    return sims.argmax(-1), labels, sims


def train_and_eval_linear_head(
    model: CLAPAudio,
    dataset_name: str,
    folds: list,
    n_classes: int,
    save_dir: str,
    *,
    epochs: int = 20,
    lr: float = 1e-3,
    mlp: bool = False,
    seed: int = 0,
    max_len: int | None = None,
) -> list[dict]:
    """K-fold linear-probe harness (`src/linear.py:56-94`): per fold, embed
    both splits, train the head from seed ``seed + fold``, evaluate, and
    write ``{save_dir}/{dataset}/Linear/evalfold_{i}.npz`` (the ResiDual
    and baseline evals' schema). ``max_len`` defaults to the model's
    ``clip_samples``."""
    if max_len is None:
        max_len = model.cfg.audio.clip_samples
    out_dir = os.path.join(save_dir, dataset_name, "Linear")
    os.makedirs(out_dir, exist_ok=True)
    results = []
    for i, (train_batches, val_batches) in enumerate(folds):
        tr_x, tr_y = embed_dataset(model, train_batches(), max_len=max_len)
        va_x, va_y = embed_dataset(model, val_batches(), max_len=max_len)
        head, history = train_linear_head(seed + i, tr_x, tr_y, n_classes, epochs=epochs,
                                          lr=lr, mlp=mlp, device=_device(model))
        preds, targets, sims = eval_linear_head(head, va_x, va_y)
        np.savez_compressed(os.path.join(out_dir, f"evalfold_{i}.npz"),
                            similarities=sims, predictions=preds, targets=targets)
        results.append({"fold": i, "accuracy": float((preds == targets).mean()),
                        "history": history})
    return results
