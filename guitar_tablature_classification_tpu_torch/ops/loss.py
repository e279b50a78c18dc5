"""Label-smoothing cross-entropy over per-string fret logits (the JAX
package's ``ops/loss.py``).

Semantics of the reference ``LabelSmoothingLoss`` (bestengine.py:63-87):
every class gets ``smoothing / (classes - 1)``, then the target class is
*overwritten* with ``1 - smoothing`` (set, not raised; each row then sums
to 1), and the loss is ``mean_batch sum_classes -true * log_softmax(pred)``,
averaged over (batch, string).  Targets are clipped to the class range.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def smoothed_true_dist(
    targets: torch.Tensor, num_classes: int, smoothing: float
) -> torch.Tensor:
    """[...] int targets -> [..., num_classes] smoothed distribution."""
    confidence = 1.0 - smoothing
    fill = smoothing / (num_classes - 1)
    one_hot = F.one_hot(targets.long(), num_classes).float()
    return one_hot * (confidence - fill) + fill


def label_smoothing_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    smoothing: float = 0.05,
    *,
    weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """logits [B, S, C], targets [B, S] int -> scalar loss.  ``weights``
    ([B, S], optional) masks invalid samples: the weighted mean over
    (batch, string), its denominator at least 1."""
    num_classes = logits.shape[-1]
    targets = torch.clamp(targets, 0, num_classes - 1)  # bestengine.py:79-81
    logp = torch.log_softmax(logits.float(), dim=-1)
    true_dist = smoothed_true_dist(targets, num_classes, smoothing)
    per_example = -torch.sum(true_dist * logp, dim=-1)  # [B, S]
    if weights is None:
        return per_example.mean()
    weights = weights.float()
    return torch.sum(per_example * weights) / torch.clamp(weights.sum(), min=1.0)


def per_string_accuracy(
    logits: torch.Tensor, targets: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-1 fret accuracy per string and overall (bestengine.py:370-380).
    Returns ([S] accuracies, scalar overall)."""
    correct = (logits.argmax(dim=-1) == targets).float()  # [B, S]
    return correct.mean(dim=0), correct.mean()
