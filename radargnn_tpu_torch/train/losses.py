"""Training losses, masked and vectorised.

Port of `radargnn_tpu/train/losses.py`:

  * weighted cross entropy with torch semantics: mean weighted by per-class
    weights, sum w[y_i]·nll_i / sum w[y_i] over valid nodes,
  * Huber (delta=1) box loss: mean over box dims per node, averaged over
    valid non-background nodes; NaN boxes are excluded,
  * total = α·cls + β·bb,
  * the orientation-angle adaption (sin-encode) and its inverse.

The class pick is a one-hot product rather than a gather or `NLLLoss`, so
the backward scatters nothing: under `torch.use_deterministic_algorithms`
`NLLLoss` refuses CUDA tensors.

Over a mesh of ranks that each hold some rows of a batch,
`detection_loss(..., group=)` gives a rank its own part of the batch's loss:
its numerators over the GLOBAL denominators (summed over the ranks outside
autograd), so the parts sum to the batch's loss and each rank
backpropagates only its own part.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from radargnn_tpu_torch.parallel.comm import all_reduce_


def _cross_entropy_terms(logits, labels, class_weights, mask):
    """(sum of w·nll, sum of w) over valid nodes."""
    logp = torch.log_softmax(logits, dim=-1)
    classes = torch.arange(logits.shape[-1], device=logits.device)
    pick = (labels.long()[:, None] == classes).to(logp.dtype)
    nll = -(logp * pick).sum(dim=-1)
    w = class_weights[labels.long()]
    if mask is not None:
        w = torch.where(mask, w, 0.0)
    return (w * nll).sum(), w.sum()


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           class_weights: torch.Tensor,
                           mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """torch.nn.CrossEntropyLoss(weight=w) over valid nodes.

    logits [N, C], labels [N] int, class_weights [C], mask [N] bool."""
    num, den = _cross_entropy_terms(logits, labels, class_weights, mask)
    return num / den.clamp(min=1e-12)


def _huber(x: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    absx = x.abs()
    return torch.where(absx < delta, 0.5 * x * x, delta * (absx - 0.5 * delta))


def masked_huber_box_loss(bb_pred: torch.Tensor, bb_true: torch.Tensor,
                          labels: torch.Tensor, bg_index: int,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Huber loss over non-background valid nodes; NaN-target nodes
    excluded. bb_pred/bb_true [N, B]; a scalar: mean over box dims per
    node, then mean over contributing nodes (0 if none)."""
    total, num = _huber_terms(bb_pred, bb_true, labels, bg_index, mask)
    return torch.where(num > 0, total / num.clamp(min=1), 0.0)


def _huber_terms(bb_pred, bb_true, labels, bg_index, mask):
    """(sum of the per-node box losses, count) over contributing nodes."""
    sel = (labels != bg_index) & torch.isfinite(bb_true).all(dim=-1)
    if mask is not None:
        sel = sel & mask
    diff = torch.where(sel[:, None], bb_true - bb_pred, 0.0)
    # NaN targets are already zeroed by sel; keep any other non-finite out
    diff = torch.where(torch.isfinite(diff), diff, 0.0)
    per_node = _huber(diff).mean(dim=-1)
    return torch.where(sel, per_node, 0.0).sum(), sel.sum()


def detection_loss(logits, bb_pred, labels, bb_true, class_weights,
                   bg_index: int, cls_loss_weight: float,
                   bb_loss_weight: float,
                   node_mask: Optional[torch.Tensor] = None, group=None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Total loss α·L_cls + β·L_bb; returns (total, cls, bb) scalars.

    With `group`, the ranks that hold the batch's rows (module docstring),
    it is this rank's part: its sums over the batch-wide class-weight sum
    and box-node count. Summed over the ranks, the parts are the whole
    batch's loss."""
    cls_num, cls_den = _cross_entropy_terms(logits, labels, class_weights,
                                            node_mask)
    bb_num, bb_den = _huber_terms(bb_pred, bb_true, labels, bg_index,
                                  node_mask)
    dens = all_reduce_(torch.stack([cls_den.detach(),
                                    bb_den.detach().to(cls_den.dtype)]),
                       group)
    l_cls = cls_num / dens[0].clamp(min=1e-12)
    l_bb = torch.where(dens[1] > 0, bb_num / dens[1].clamp(min=1), 0.0)
    return cls_loss_weight * l_cls + bb_loss_weight * l_bb, l_cls, l_bb


def adapt_bb_orientation_angle(boxes: torch.Tensor) -> torch.Tensor:
    """Maps rotated-box θ from [0, π] to sin-encoded [-1, 1]: angles above
    π/2 are flipped by -π, then sin. NaN rows pass through unchanged.
    Works for [..., 5] box tensors (columns 0-3 untouched)."""
    boxes = torch.as_tensor(boxes)
    theta = boxes[..., 4]
    shifted = torch.where(theta > math.pi / 2, theta - math.pi, theta)
    out_theta = torch.where(torch.isnan(boxes[..., 0]), theta,
                            torch.sin(shifted))
    return torch.cat([boxes[..., :4], out_theta[..., None]], dim=-1)


def invert_bb_orientation_angle_adaption(theta) -> torch.Tensor:
    """Inverse of the sin-encoding: [-1, 1] -> [0, π] rad."""
    unsmoothed = torch.arcsin(torch.as_tensor(theta).clamp(-1.0, 1.0))
    return torch.where(unsmoothed < 0, unsmoothed + math.pi, unsmoothed)
