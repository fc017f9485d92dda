"""Hungarian assignment for the query head: pairwise costs on the device,
scipy's solve on the host.

Counterpart of ``rsprompter_tpu/models/task_modules/hungarian.py``
(reference ``mmdet/models/task_modules/assigners/hungarian_assigner.py`` with
the RSPrompter-query costs: ClassificationCost(2.0) +
CrossEntropyLossCost(5.0, sigmoid) + DiceCost(5.0, pred_act, eps=1.0) on
shared random points). :func:`hungarian_match_batched` copies the stacked
cost matrices of every decoder layer and image, with the GT validity, to the
host in one transfer, the step's one device-to-host trip, and solves each with
``scipy.optimize.linear_sum_assignment``. JAX's on-device auction serves its
TPU, which has no host callbacks; the port does not need it.

The costs broadcast over leading dimensions: (..., Q, ·) predictions
against (..., G, ·) targets give (..., Q, G).
"""

from __future__ import annotations

import numpy as np
import torch

BIG_COST = 1e8


def _lsa_host(cost: np.ndarray, gt_valid: np.ndarray) -> np.ndarray:
    """cost (Q, G), gt_valid (G,) -> the query matched to each GT (G,), -1
    for invalid GT (and for valid GT left over when they outnumber the
    queries)."""
    from scipy.optimize import linear_sum_assignment

    out = -np.ones(cost.shape[1], np.int64)
    valid_idx = np.flatnonzero(gt_valid)
    if len(valid_idx) == 0:
        return out
    sub = cost[:, valid_idx]
    sub = np.where(np.isfinite(sub), sub, BIG_COST)
    rows, cols = linear_sum_assignment(sub)
    out[valid_idx[cols]] = rows
    return out


def _lsa_host_batched(cost: np.ndarray, gt_valid: np.ndarray) -> np.ndarray:
    """cost (N, Q, G), gt_valid (N, G) -> (N, G)."""
    return np.stack([_lsa_host(cost[i], gt_valid[i]) for i in range(cost.shape[0])])


def hungarian_match_batched(cost: torch.Tensor, gt_valid: torch.Tensor) -> torch.Tensor:
    """cost (..., Q, G), gt_valid (..., G) (broadcast to the cost's leading
    dimensions) -> matched query per GT (..., G) int64 on the cost's device.
    One device-to-host copy of the costs and the validity together."""
    *lead, q, g = cost.shape
    valid = gt_valid.expand(*lead, g)
    host = torch.cat([cost.detach().float().reshape(-1),
                      valid.float().reshape(-1)]).cpu().numpy()
    n = int(np.prod(lead)) if lead else 1
    c = host[: n * q * g].reshape(n, q, g)
    v = host[n * q * g:].reshape(n, g) > 0.5
    matched = _lsa_host_batched(c, v).reshape(*lead, g)
    return torch.from_numpy(matched).to(cost.device)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) without torch's linear cut-off above 20 (JAX's)."""
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def classification_cost(cls_logits: torch.Tensor, gt_labels: torch.Tensor) -> torch.Tensor:
    """-softmax probability of the GT class: (..., Q, C+1), (..., G) -> (..., Q, G)."""
    probs = torch.softmax(cls_logits.float(), dim=-1)
    idx = gt_labels.long().unsqueeze(-2).expand(*probs.shape[:-1], gt_labels.shape[-1])
    return -torch.gather(probs, -1, idx)


def bce_cost(pred_pts: torch.Tensor, gt_pts: torch.Tensor) -> torch.Tensor:
    """Pairwise sigmoid cross-entropy, mean over the points: (..., Q, P)
    logits, (..., G, P) {0, 1} -> (..., Q, G)."""
    p = pred_pts.shape[-1]
    gt_t = gt_pts.float().transpose(-1, -2)
    pos = _softplus(-pred_pts.float())  # -log sigmoid
    neg = _softplus(pred_pts.float())  # -log(1 - sigmoid)
    return (pos @ gt_t + neg @ (1.0 - gt_t)) / p


def dice_cost(pred_pts: torch.Tensor, gt_pts: torch.Tensor, eps: float = 1.0) -> torch.Tensor:
    """Pairwise dice cost on the sampled points, predictions through a
    sigmoid: (..., Q, P), (..., G, P) -> (..., Q, G)."""
    pred = torch.sigmoid(pred_pts.float())
    gt = gt_pts.float()
    num = 2 * (pred @ gt.transpose(-1, -2))
    den = pred.sum(-1)[..., :, None] + gt.sum(-1)[..., None, :]
    return -(num + eps) / (den + eps) + 1.0
