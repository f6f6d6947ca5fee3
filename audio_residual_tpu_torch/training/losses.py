"""Contrastive and linear-probe losses, from
``audio_residual_tpu/training/losses.py`` (the reference's `loss.py`).

  * :func:`gather_features` (`loss.py:15-91`): the features of every rank of
    a ``torch.distributed`` process group, through
    ``torch.distributed.nn.functional.all_gather``, which differentiates (its
    backward sums each rank's gradient into the shard it came from), as the
    JAX package's ``all_gather`` over its mesh axis does. A plain
    ``dist.all_gather`` would drop that gradient silently.
  * :func:`clip_loss` (`loss.py:93-221`): symmetric InfoNCE over the global
    batch; 2-term (audio @ text) or 4-term ``mlp_loss`` (audio @ text_mlp +
    text @ audio_mlp); ``local_loss`` (local x global logits with
    rank-offset labels); the κ-weighted variant (``--kappa``).
  * :func:`lp_loss` (`loss.py:291-306`): the linear probe's heads;
    :func:`lp_metrics` (`loss.py:246-283`) its accuracy, mAP and mAUC.

``group`` takes the place of the JAX package's ``axis_name``: None is one
process; a process group makes the loss that of the batch of every rank, its
value the mean over the ranks (the JAX package's ``pmean``), and its gradient
the one ``DistributedDataParallel``'s averaging of the ranks' gradients turns
into the single-process gradient of the whole batch.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["gather_features", "clip_loss", "contrastive_weights", "lp_loss", "lp_metrics"]


def _world(group) -> tuple[int, int]:
    import torch.distributed as dist

    return dist.get_rank(group), dist.get_world_size(group)


def gather_features(audio_features, text_features, audio_features_mlp=None,
                    text_features_mlp=None, *, group=None, local_loss: bool = False,
                    mlp_loss: bool = False) -> tuple:
    """``(all_audio, all_text[, all_audio_mlp, all_text_mlp])``: each the
    rows of every rank in rank order, differentiable (`loss.py:15-91`,
    ``gather_with_grad``). ``group=None`` returns the inputs."""
    outs = (audio_features, text_features, audio_features_mlp, text_features_mlp)
    if group is not None:
        from torch.distributed.nn.functional import all_gather

        outs = tuple(None if t is None else torch.cat(all_gather(t, group=group), dim=0)
                     for t in outs)
    return outs if mlp_loss else outs[:2]


def _ce_rows(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return -F.log_softmax(logits, dim=-1).gather(-1, labels[:, None])[:, 0]


def contrastive_weights(features: torch.Tensor, kappa: float) -> torch.Tensor:
    """Per-sample weights of the weighted contrastive loss
    (`loss.py:166-170,213-216`): ``exp(rowsum(F @ F.T) / (kappa * N))``,
    detached."""
    sims = features @ features.T
    return torch.exp(sims.sum(dim=1) / (kappa * features.shape[0])).detach()


def _weighted_ce(logits, labels, w) -> torch.Tensor:
    """``F.cross_entropy(..., weight=w)`` with contrastive labels: the
    ``w[labels]``-weighted mean of the rows' CE, normalised by their sum."""
    wl = w[labels]
    return (wl * _ce_rows(logits, labels)).sum() / wl.sum()


def clip_loss(outputs: dict, *, group=None, local_loss: bool = False, mlp_loss: bool = False,
              weight_loss_kappa: float = 0.0) -> torch.Tensor:
    """Symmetric InfoNCE over the (global) batch (`loss.py:131-221`), on
    :func:`~audio_residual_tpu_torch.models.clap.clap_apply`'s output dict.

    Labels are ``arange(global_batch)``, or with ``local_loss`` under a
    ``group`` the local rows' rank-offset labels (`loss.py:151-152`). The
    4-term loss scales its transposed terms with their partner's scale
    (``a_logits_per_text = a_logits_per_audio.T``, `loss.py:138-146`);
    under ``local_loss`` ``scale_a`` pairs with the products against the
    gathered text MLP features and ``scale_t`` with those against the
    audio ones (`loss.py:131-137`). ``weight_loss_kappa`` weights the CE
    as the reference does: the 2-term loss crosses the weights (audio
    logits by the text weights) computed on the gathered features; the
    4-term loss pairs same-modality weights on the local features, which
    the reference cannot run on several ranks, so that combination
    raises."""
    a, t = outputs["audio_features"], outputs["text_features"]
    n_local = a.shape[0]
    rank = 0
    if group is not None:
        rank, world = _world(group)
    if mlp_loss:
        am, tm = outputs["audio_features_mlp"], outputs["text_features_mlp"]
        all_a, all_t, all_am, all_tm = gather_features(a, t, am, tm, group=group,
                                                       local_loss=local_loss, mlp_loss=True)
        sa, st = outputs["logit_scale_a"], outputs["logit_scale_t"]
        if local_loss and group is not None:
            a_logits = sa * a @ all_tm.T
            a_logits_r = sa * tm @ all_a.T
            t_logits = st * am @ all_t.T
            t_logits_r = st * t @ all_am.T
            labels = torch.arange(n_local, device=a.device) + rank * n_local
        else:
            a_logits = sa * all_a @ all_tm.T
            a_logits_r = a_logits.T
            t_logits = st * all_am @ all_t.T
            t_logits_r = t_logits.T
            labels = torch.arange(a_logits.shape[0], device=a.device)
        if weight_loss_kappa:
            if group is not None:
                raise NotImplementedError(
                    "weighted 4-term loss under data sharding: the reference computes weights "
                    "on LOCAL features (loss.py:166-170), which crashes multi-rank torch "
                    "(N_local weights vs N_global classes) -- no semantics to match")
            aw = contrastive_weights(a, weight_loss_kappa)
            tw = contrastive_weights(t, weight_loss_kappa)
            loss = (_weighted_ce(a_logits, labels, aw) + _weighted_ce(a_logits_r, labels, aw)
                    + _weighted_ce(t_logits, labels, tw)
                    + _weighted_ce(t_logits_r, labels, tw)) / 4.0
        else:
            loss = (_ce_rows(a_logits, labels).mean() + _ce_rows(a_logits_r, labels).mean()
                    + _ce_rows(t_logits, labels).mean()
                    + _ce_rows(t_logits_r, labels).mean()) / 4.0
    else:
        all_a, all_t = gather_features(a, t, group=group, local_loss=local_loss)
        scale = outputs["logit_scale_a"]
        if local_loss and group is not None:
            logits_a = scale * a @ all_t.T
            logits_t = scale * t @ all_a.T
            labels = torch.arange(n_local, device=a.device) + rank * n_local
        else:
            logits_a = scale * all_a @ all_t.T
            logits_t = logits_a.T
            labels = torch.arange(logits_a.shape[0], device=a.device)
        if weight_loss_kappa:
            aw = contrastive_weights(all_a, weight_loss_kappa)
            tw = contrastive_weights(all_t, weight_loss_kappa)
            loss = 0.5 * (_weighted_ce(logits_a, labels, tw) + _weighted_ce(logits_t, labels, aw))
        else:
            loss = 0.5 * (_ce_rows(logits_a, labels).mean() + _ce_rows(logits_t, labels).mean())
    if group is not None:
        # the mean over the ranks (pmean): the backward of the all-reduce sums
        # the 1/world cotangents back to one per rank, so the gradients are
        # those of the local loss, which DDP's averaging makes global
        from torch.distributed.nn.functional import all_reduce

        loss = all_reduce(loss, group=group) / world
    return loss


def lp_loss(pred: torch.Tensor, target: torch.Tensor, kind: str = "ce") -> torch.Tensor:
    """Linear-probe losses: ``bce`` (multi-label, on logits), ``ce`` (int
    targets, or soft targets of the logits' shape, as mixup makes them),
    ``mse``."""
    if kind == "ce":
        logp = F.log_softmax(pred, dim=-1)
        if target.ndim == 1:
            return -logp.gather(-1, target.long()[:, None]).mean()
        return (-(target * logp).sum(dim=-1)).mean()
    if kind == "bce":
        z, t = pred, target.to(pred.dtype)
        return (torch.clamp(z, min=0) - z * t + torch.log1p(torch.exp(-z.abs()))).mean()
    if kind == "mse":
        return ((pred - target.to(pred.dtype)) ** 2).mean()
    raise ValueError(kind)


def _average_precision(y: np.ndarray, s: np.ndarray) -> float:
    """Step-wise average precision of one class (``sklearn``'s
    ``average_precision_score``; 0 for a class without positives)."""
    if not y.any():
        return 0.0
    order = np.argsort(-s, kind="mergesort")
    s, y = s[order], y[order]
    last = np.r_[np.flatnonzero(np.diff(s)), len(s) - 1]  # the end of each score's run
    tps = np.cumsum(y)[last]
    precision = tps / (last + 1)
    recall = tps / tps[-1]
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def _roc_auc(y: np.ndarray, s: np.ndarray) -> float:
    """Area under the ROC curve of one class by the trapezoid rule over the
    distinct scores; nan when the class or its complement is absent
    (``sklearn``'s macro average then gives nan)."""
    if y.all() or not y.any():
        return float("nan")
    order = np.argsort(-s, kind="mergesort")
    s, y = s[order], y[order]
    last = np.r_[np.flatnonzero(np.diff(s)), len(s) - 1]
    tps = np.cumsum(y)[last]
    fps = last + 1 - tps
    tpr, fpr = np.r_[0.0, tps / tps[-1]], np.r_[0.0, fps / fps[-1]]
    return float(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2))


def lp_metrics(pred: np.ndarray, target: np.ndarray, metrics=("acc", "map", "mauc")) -> dict:
    """Linear-probe metrics (`loss.py:246-283`): accuracy, macro mAP and
    macro ROC AUC over one-hot targets, in numpy (the JAX package calls
    sklearn, which the card's machine does not have)."""
    pred = np.asarray(pred, np.float64)
    target = np.asarray(target)
    onehot = np.eye(pred.shape[-1])[target] if target.ndim == 1 else target
    onehot = onehot > 0.5
    out = {}
    if "acc" in metrics:
        out["acc"] = float((pred.argmax(-1) == onehot.argmax(-1)).mean())
    if "map" in metrics:
        out["map"] = float(np.mean([_average_precision(onehot[:, c], pred[:, c])
                                    for c in range(pred.shape[-1])]))
    if "mauc" in metrics:
        out["mauc"] = float(np.mean([_roc_auc(onehot[:, c], pred[:, c])
                                     for c in range(pred.shape[-1])]))
    return out
