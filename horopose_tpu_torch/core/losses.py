"""The elementwise and norm losses of the supervised engine.

Port of `horopose_tpu/core/losses.py` (:14-77): mse / l1 / smoothl1 with an
optional (B,) row mask, the masked l2-norm loss, and the translation l2norm
with the reference's outlier down-weighting. `iou_loss` belongs to the
sim2real stage, which is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch


def row_mean(x: torch.Tensor, row_mask: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
    """Mean of a per-element loss array over the valid batch rows.

    row_mask is an optional (B,) 0/1 validity vector (the eval pipelines'
    `_valid` pad mask): padded rows contribute exactly zero, so the result
    equals the plain mean over the unpadded batch. None is the plain mean.
    """
    if row_mask is None:
        return x.mean()
    w = row_mask.reshape((-1,) + (1,) * (x.dim() - 1))
    per_row = x.numel() // x.shape[0]
    denom = torch.clamp(row_mask.sum() * per_row, min=1.0)
    return (x * w).sum() / denom


def mse(a, b, row_mask=None):
    return row_mean((a - b) ** 2, row_mask)


def l1(a, b, row_mask=None):
    return row_mean((a - b).abs(), row_mask)


def smooth_l1(a, b, beta: float = 1.0, row_mask=None):
    d = (a - b).abs()
    return row_mean(torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta),
                    row_mask)


_ELEMWISE = {"mse": mse, "l1": l1, "smoothl1": smooth_l1}


def elementwise_loss(kind: str, a, b, row_mask=None):
    if kind not in _ELEMWISE:
        raise NotImplementedError(f"loss func {kind}")
    return _ELEMWISE[kind](a, b, row_mask=row_mask)


def masked_norm_loss(pred, gt, mask=None, dim: int = -1, row_mask=None):
    """l2norm: mean of per-element euclidean errors, optionally weighted by a
    validity mask (mean over valid entries) and/or a (B,) row pad mask."""
    err = torch.linalg.norm(pred - gt, dim=dim)
    if row_mask is not None:
        rm = row_mask.reshape((-1,) + (1,) * (err.dim() - 1)).expand(
            err.shape)
        mask = rm if mask is None else mask * rm
    if mask is None:
        return err.mean()
    return (err * mask).sum() / torch.clamp((mask != 0).sum(), min=1)


def trans_l2norm_with_outlier_downweight(pred, gt, threshold: float = 0.5,
                                         alpha: float = 20.0, row_mask=None):
    """The reference's trans l2norm: if the batch-mean error exceeds 0.5 m,
    re-weight each error by the detached exp(-20 * err)."""
    err = torch.linalg.norm(pred - gt, dim=-1)
    mean_err = row_mean(err, row_mask)
    coeff = torch.exp(-alpha * err).detach()
    downweighted = row_mean(err * coeff, row_mask)
    return torch.where(mean_err > threshold, downweighted, mean_err)
