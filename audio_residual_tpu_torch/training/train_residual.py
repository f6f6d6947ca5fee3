"""ResiDual zero-shot training: learn the spectral-reweighting λ against fixed
class-text embeddings with a cross-entropy objective.

Port of ``audio_residual_tpu/training/train_residual.py`` (the reference's
``src/training.py:12-140`` and ``src/evaluation.py:19-128``), with its
signatures and semantics, except that the model (a
:class:`~audio_residual_tpu_torch.models.clap.CLAPAudio`, which carries its
config) takes the place of ``params`` and ``cfg``.

λ is the only tensor that requires grad: the model's weights are frozen, so
autograd builds only the thin chain through the ResiDual epilogues. The
kernels on that chain (K2-K5) run forward on the card and differentiate
their plain versions (:mod:`audio_residual_tpu_torch.ops.cuda.autograd`), as
the JAX package's ``custom_vjp``s do; K1 sits before every cut and runs
forward only.

Everything runs on the model's device: the prefix caches stay there (the
JAX package keeps them on the host), and only the eval results come back as
numpy arrays.

Reference quirks kept as the JAX package keeps them: the encoder runs with
eval statistics in training; evaluation int16-quantises waveforms, training
does not; ``double_ffn_compat=True`` reproduces the patched block's double
FFN; trained λ is saved.

Crops: in the uncached loop, clips longer than ``max_len`` are cropped at
starts drawn per step from a ``torch.Generator`` seeded from ``seed``; the
JAX package draws them from ``jax.random``, so those crops are not bit-equal
to the JAX package's (clips at most ``max_len`` long are not cropped).
"""

from __future__ import annotations

import os
from typing import Callable, Iterable

import numpy as np
import torch

from audio_residual_tpu_torch.data.featurize import featurize_batch
from audio_residual_tpu_torch.models.clap import CLAPAudio, encode_audio
from audio_residual_tpu_torch.ops.quantize import quantize_roundtrip
from audio_residual_tpu_torch.residual.module import load_residual_params, save_residual_params
from audio_residual_tpu_torch.utils.profiling import annotate

__all__ = [
    "adam",
    "make_zero_shot_step",
    "cache_prefix_tokens",
    "cache_prefix_images",
    "train_residual",
    "evaluate_zero_shot",
    "train_and_evaluate_residual",
    "evaluate_baseline_clap",
    "train_with_config",
]


def _device(model: CLAPAudio) -> torch.device:
    return model.audio_projection[0].weight.device


def _split_residual(residual: dict):
    """``(lam, frozen)``: λ as fresh leaf tensors that require grad (the
    caller's tensors are left as they are), basis and mean frozen."""
    lam = {l: r["lam"].detach().clone().requires_grad_(True) for l, r in residual.items()}
    frozen = {l: {"basis": r["basis"], "mean": r["mean"]} for l, r in residual.items()}
    return lam, frozen


def _merge_residual(lam: dict, frozen: dict):
    return {l: {**frozen[l], "lam": lam[l]} for l in frozen}


def adam(lam: dict, lr: float) -> torch.optim.Adam:
    """Adam over the λ tensors, in place of the JAX package's ``optax.adam(lr)``.

    Both use β1 0.9, β2 0.999, eps 1e-8 and the same bias correction:
    optax ``m̂ = m / (1 - β1^t)``, ``v̂ = v / (1 - β2^t)``,
    ``λ -= lr m̂ / (sqrt(v̂) + eps)``; torch
    ``λ -= lr / (1 - β1^t) * m / (sqrt(v) / sqrt(1 - β2^t) + eps)``, the
    same expression."""
    return torch.optim.Adam(list(lam.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def make_zero_shot_step(
    model: CLAPAudio,
    text_embeds: torch.Tensor,
    frozen_residual: dict,
    optimizer: torch.optim.Optimizer,
    *,
    max_len: int = 480000,
    double_ffn_compat: bool = True,
    compute_dtype=None,
    start_layer: int = 0,
    tokens_input: bool = False,
    image_input: bool = False,
):
    """``(step, loss_fn)``. ``loss_fn(lam, x, labels, generator=None) ->
    (loss, n_correct)``: the mean log-softmax cross-entropy of
    ``normalized @ text_embeds.T`` and the count of correct argmaxes.
    ``step(lam, x, labels, generator=None) -> (loss, n_correct)`` also
    takes one ``optimizer`` step (Adam over ``lam``'s tensors: :func:`adam`),
    updating ``lam`` in place.

    ``x`` is a waveform batch, or with ``tokens_input`` cached frozen-prefix
    tokens (:func:`cache_prefix_tokens`, resumed at ``start_layer``), or with
    ``image_input`` cached post-frontend images (:func:`cache_prefix_images`).
    ``generator`` draws the crops of clips over ``max_len``.
    ``compute_dtype`` defaults to the golden f32 path, as in the JAX package."""
    device = _device(model)
    text = torch.as_tensor(text_embeds, device=device, dtype=torch.float32)

    def loss_fn(lam, x, labels, generator=None):
        residual = _merge_residual(lam, frozen_residual)
        x = torch.as_tensor(x, device=device)
        if tokens_input:
            batch = {"tokens": x}
        elif image_input:
            batch = {"image": x}
        else:
            batch = featurize_batch(x, max_len, generator=generator)
        out = encode_audio(model, batch, residual=residual, double_ffn_compat=double_ffn_compat,
                           compute_dtype=compute_dtype, start_layer=start_layer)
        sims = out["normalized"] @ text.t()
        labels = torch.as_tensor(labels, device=device, dtype=torch.long)
        logp = torch.log_softmax(sims, dim=-1)
        loss = -logp.gather(-1, labels[:, None]).mean()
        correct = (sims.argmax(-1) == labels).sum()
        return loss, correct

    def step(lam, x, labels, generator=None):
        optimizer.zero_grad(set_to_none=True)
        with annotate("train.forward"):
            loss, correct = loss_fn(lam, x, labels, generator)
        with annotate("train.backward"):
            loss.backward()
        optimizer.step()
        return loss.detach(), correct

    return step, loss_fn


def _prefix(model: CLAPAudio, wav, labels, max_len: int, quantize: bool, **split) -> tuple:
    """``(prefix, labels)`` of one batch on the model's device: ``split`` is
    ``stop_at_layer=l`` or ``stop_at_image=True``."""
    device = _device(model)
    with torch.no_grad():
        wav = torch.as_tensor(wav, device=device, dtype=torch.float32)
        if quantize:
            wav = quantize_roundtrip(wav)
        # a fixed generator: a crop stays random-positioned but deterministic
        batch = featurize_batch(wav, max_len, generator=torch.Generator().manual_seed(0))
        (x,) = encode_audio(model, batch, **split).values()
    return x, torch.as_tensor(labels, device=device, dtype=torch.long)


def cache_prefix_tokens(
    model: CLAPAudio,
    batches: Iterable,
    until_layer: int,
    *,
    max_len: int = 480000,
    exact_only: bool = False,
    quantize: bool = False,
) -> list | None:
    """Run the frozen encoder prefix (frontend, patch embed and the layers
    below ``until_layer``) once; ``[(tokens, labels)]`` on the model's
    device, so each epoch pays only for the suffix.

    ``exact_only=True`` returns None as soon as a batch is longer than
    ``max_len``: such clips are cropped afresh every step in the uncached
    loop, which a one-shot cache would freeze. ``quantize=True`` applies the
    eval path's int16 round-trip first (caches for
    :func:`evaluate_zero_shot`)."""
    out = []
    for wav, labels in batches:
        if exact_only and wav.shape[-1] > max_len:
            return None
        out.append(_prefix(model, wav, labels, max_len, quantize, stop_at_layer=until_layer))
    return out


def cache_prefix_images(
    model: CLAPAudio,
    batches: Iterable,
    *,
    max_len: int = 480000,
    quantize: bool = False,
) -> list:
    """Run frontend, bn0 and ``reshape_wav2img`` once; ``[(image [B, H, W,
    1], labels)]`` on the model's device. The cut that pays when layer 0 is
    injected (the published best config), where the layer-0 tokens would
    outweigh the waveform: every epoch skips the frontend and the bicubic
    stretch while all token-level compute and the λ gradient stay live. The
    resume runs the same operations as the uncached forward; the caller
    checks clip lengths as for the token cut."""
    return [_prefix(model, wav, labels, max_len, quantize, stop_at_image=True)
            for wav, labels in batches]


def train_residual(
    model: CLAPAudio,
    train_batches: Callable[[], Iterable],
    text_embeds,
    residual: dict,
    *,
    epochs: int = 10,
    lr: float = 0.01,
    max_len: int = 480000,
    double_ffn_compat: bool = True,
    log_fn: Callable[[dict], None] | None = None,
    cache_prefix: bool | None = None,
    seed: int = 0,
) -> tuple[dict, list[dict]]:
    """Train λ (`src/training.py:12-41`, Adam as `evaluation.py:54`).

    ``train_batches()`` yields ``(wav [B, T], labels [B])`` pairs (numpy or
    tensors). Returns the trained residual dict (λ detached) and the
    per-epoch history. ``cache_prefix``: None (auto) caches whenever
    featurization is deterministic (every clip at most ``max_len``), True
    forces it (crops of longer clips freeze), False disables it. The cut:
    tokens below the first injected layer when that layer is >= 1
    (:func:`cache_prefix_tokens`), else the post-frontend image
    (:func:`cache_prefix_images`). Uncached steps draw crops from a
    generator seeded from ``seed``."""
    lam, frozen = _split_residual(residual)
    optimizer = adam(lam, lr)
    start_layer = 0
    if cache_prefix is None:
        # a length pre-scan on a fresh iterator, before any prefix compute
        cache_prefix = all(wav.shape[-1] <= max_len for wav, _ in train_batches())
    if cache_prefix:
        if min(frozen) >= 1:
            start_layer = min(frozen)
            cached = cache_prefix_tokens(model, train_batches(), start_layer, max_len=max_len)
        else:
            cached = cache_prefix_images(model, train_batches(), max_len=max_len)
        train_batches = lambda: iter(cached)  # noqa: E731
    step, _ = make_zero_shot_step(
        model, text_embeds, frozen, optimizer, max_len=max_len,
        double_ffn_compat=double_ffn_compat, start_layer=start_layer,
        tokens_input=cache_prefix and start_layer > 0,
        image_input=cache_prefix and start_layer == 0,
    )
    generator = None if cache_prefix else torch.Generator().manual_seed(seed)
    history = []
    for e in range(epochs):
        total_loss, correct, total = 0.0, 0, 0
        for x, labels in train_batches():
            loss, c = step(lam, x, labels, generator)
            bs = x.shape[0]
            total_loss += float(loss) * bs
            correct += int(c)
            total += bs
        rec = {"epoch": e, "train_loss": total_loss / max(total, 1),
               "train_acc": correct / max(total, 1)}
        history.append(rec)
        if log_fn:
            log_fn(rec)
    return _merge_residual({l: v.detach() for l, v in lam.items()}, frozen), history


def evaluate_zero_shot(
    model: CLAPAudio,
    batches: Iterable,
    text_embeds,
    *,
    residual: dict | None = None,
    max_len: int = 480000,
    double_ffn_compat: bool = True,
    quantize: bool = True,
    start_layer: int = 0,
    image_input: bool = False,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (predictions, targets, similarities) as numpy arrays, with the
    reference eval path's int16 round-trip (`src/evaluation.py:93`).
    ``start_layer > 0``: batches carry cached tokens (built with
    ``quantize=True``); ``image_input``: cached images."""
    device = _device(model)
    text = torch.as_tensor(text_embeds, device=device, dtype=torch.float32)
    sims_all, targets_all = [], []
    with torch.no_grad():
        for x, labels in batches:
            x = torch.as_tensor(x, device=device)
            if start_layer > 0:
                batch = {"tokens": x}
            elif image_input:
                batch = {"image": x}
            else:
                if quantize:
                    x = quantize_roundtrip(x.float())
                batch = featurize_batch(x, max_len, generator=torch.Generator().manual_seed(0))
            out = encode_audio(model, batch, residual=residual,
                               double_ffn_compat=double_ffn_compat, start_layer=start_layer)
            sims_all.append((out["normalized"] @ text.t()).cpu().numpy())
            targets_all.append(np.asarray(torch.as_tensor(labels).cpu()))
    similarities = np.concatenate(sims_all)
    targets = np.concatenate(targets_all)
    return similarities.argmax(-1), targets, similarities


def _kfold_npz(save_file, preds, targets, sims):
    os.makedirs(os.path.dirname(save_file), exist_ok=True)
    np.savez_compressed(save_file, similarities=sims, predictions=np.asarray(preds),
                        targets=np.asarray(targets))


def _load_residuals(model, pca_path, dataset_name, layers, fold) -> dict:
    return {l: load_residual_params(
        os.path.join(pca_path, dataset_name, f"layer_{l}_evalfold_{fold}"),
        device=_device(model)) for l in layers}


def train_and_evaluate_residual(
    model: CLAPAudio,
    dataset_name: str,
    folds: list,
    text_embeds,
    pca_path: str,
    save_dir: str,
    *,
    epochs: int = 10,
    lr: float = 0.01,
    inject_layers: tuple[int, ...] = (0,),
    double_ffn_compat: bool = True,
    save_lambda: bool = True,
    max_len: int | None = None,
    cache_prefix: bool | None = None,
) -> list[dict]:
    """K-fold harness (`src/evaluation.py:19-71`): per fold, load the
    per-(layer, fold) PCA basis, train λ, evaluate, write
    ``{save_dir}/{dataset}/ResiDual/layers_{l}_evalfold_{i}.npz`` and the
    trained ``lambda_layer{l}_evalfold_{i}.pkl``. ``max_len`` defaults to
    the model's ``clip_samples``."""
    if max_len is None:
        max_len = model.cfg.audio.clip_samples
    layers_str = "_".join(map(str, inject_layers))
    out_dir = os.path.join(save_dir, dataset_name, "ResiDual")
    results = []
    for i, (train_batches, val_batches) in enumerate(folds):
        residual = _load_residuals(model, pca_path, dataset_name, inject_layers, i)
        trained, history = train_residual(
            model, train_batches, text_embeds, residual, epochs=epochs, lr=lr,
            double_ffn_compat=double_ffn_compat, max_len=max_len, cache_prefix=cache_prefix,
        )
        preds, targets, sims = evaluate_zero_shot(
            model, val_batches(), text_embeds, residual=trained,
            double_ffn_compat=double_ffn_compat, max_len=max_len,
        )
        _kfold_npz(os.path.join(out_dir, f"layers_{layers_str}_evalfold_{i}.npz"), preds,
                   targets, sims)
        if save_lambda:
            for l, r in trained.items():
                save_residual_params(os.path.join(out_dir, f"lambda_layer{l}_evalfold_{i}.pkl"),
                                     r)
        results.append({"fold": i, "accuracy": float((preds == targets).mean()),
                        "history": history})
    return results


def evaluate_baseline_clap(
    model: CLAPAudio,
    dataset_name: str,
    folds: list,
    text_embeds,
    save_dir: str,
    max_len: int | None = None,
) -> list[dict]:
    """Zero-shot baseline per fold (`src/evaluation.py:112-128`):
    ``{save_dir}/{dataset}/Baseline/evalfold_{i}.npz``."""
    if max_len is None:
        max_len = model.cfg.audio.clip_samples
    out_dir = os.path.join(save_dir, dataset_name, "Baseline")
    results = []
    for i, (_, val_batches) in enumerate(folds):
        preds, targets, sims = evaluate_zero_shot(model, val_batches(), text_embeds,
                                                  max_len=max_len)
        _kfold_npz(os.path.join(out_dir, f"evalfold_{i}.npz"), preds, targets, sims)
        results.append({"fold": i, "accuracy": float((preds == targets).mean())})
    return results


def train_with_config(
    config: dict,
    model: CLAPAudio,
    dataset_name: str,
    folds: list,
    text_embeds,
    pca_path: str,
    *,
    log_fn: Callable[[dict], None] | None = None,
) -> dict:
    """One sweep run (`src/training.py:72-140`): pick the eval fold, load the
    per-(layer, fold) PCA, train, track the best val accuracy. ``config``
    keys: ``lr``, ``epochs``, ``inject_layers``, ``eval_fold``, ``max_len``
    (default the model's ``clip_samples``). Train and val prefixes are
    cached once (the loop draws no crops, so the cache is exact): tokens
    below the first injected layer >= 1, else the images."""
    max_len = config.get("max_len", model.cfg.audio.clip_samples)
    fold = config.get("eval_fold", 0)
    inject_layers = tuple(config.get("inject_layers", (0,)))
    train_batches, val_batches = folds[fold]
    residual = _load_residuals(model, pca_path, dataset_name, inject_layers, fold)
    best_val_acc = 0.0
    lam, frozen = _split_residual(residual)
    optimizer = adam(lam, config.get("lr", 0.01))
    start_layer = 0
    image_input = False
    if min(frozen) >= 1:
        start_layer = min(frozen)
        cached = cache_prefix_tokens(model, train_batches(), start_layer, max_len=max_len)
        val_cached = cache_prefix_tokens(model, val_batches(), start_layer, max_len=max_len,
                                         quantize=True)
    else:
        image_input = True
        cached = cache_prefix_images(model, train_batches(), max_len=max_len)
        val_cached = cache_prefix_images(model, val_batches(), max_len=max_len, quantize=True)
    step, _ = make_zero_shot_step(model, text_embeds, frozen, optimizer, max_len=max_len,
                                  start_layer=start_layer, tokens_input=start_layer > 0,
                                  image_input=image_input)
    history = []
    for e in range(config.get("epochs", 10)):
        tl, tc, tn = 0.0, 0, 0
        for x, labels in cached:
            loss, c = step(lam, x, labels)
            tl += float(loss) * len(labels)
            tc += int(c)
            tn += len(labels)
        preds, targets, _ = evaluate_zero_shot(
            model, iter(val_cached), text_embeds,
            residual=_merge_residual(lam, frozen), max_len=max_len,
            start_layer=start_layer, image_input=image_input,
        )
        val_acc = float((preds == targets).mean())
        best_val_acc = max(best_val_acc, val_acc)
        rec = {
            "epoch": e,
            "train_loss": tl / max(tn, 1),
            "train_acc": tc / max(tn, 1),
            "val_acc": val_acc,
            "lambda_hist": {l: v.detach().cpu().numpy().copy() for l, v in lam.items()},
        }
        history.append(rec)
        if log_fn:
            log_fn(rec)
    return {"best_val_acc": best_val_acc, "history": history,
            "residual": _merge_residual({l: v.detach() for l, v in lam.items()}, frozen)}
