"""Evaluation metrics: confusion matrices, per-fret accuracy (the JAX
package's ``train/metrics.py``).

Equivalents of the sklearn/seaborn metric computations in the reference's
visualization suite (bestengine.py:608-686 confusion matrices, :729-811
per-fret accuracy heatmap data).  ``confusion_matrices`` runs on the
device of its inputs; the other two are NumPy.
"""

from __future__ import annotations

import numpy as np
import torch


def confusion_matrices(
    preds: torch.Tensor, targets: torch.Tensor, num_classes: int = 19
) -> torch.Tensor:
    """preds/targets [N, S] int -> [S, num_classes, num_classes] int64
    counts (rows = true fret, cols = predicted fret).  Out-of-range pairs
    are handled as ``jnp.bincount(length=...)`` handles them: a negative
    cell index counts at cell 0, one past the last cell is dropped."""
    preds = torch.as_tensor(preds).long()
    targets = torch.as_tensor(targets).long().to(preds.device)
    s = preds.shape[1]
    cells = num_classes * num_classes
    flat = (targets * num_classes + preds).clamp(min=0)
    keep = flat < cells
    # one bincount over (string, cell): string j's cells start at j * cells
    flat = flat + torch.arange(s, device=preds.device) * cells
    counts = torch.bincount(flat[keep], minlength=s * cells)
    return counts.reshape(s, num_classes, num_classes)


def row_normalize(cm: np.ndarray) -> np.ndarray:
    """Row-normalized confusion matrix (bestengine.py:649)."""
    cm = np.asarray(cm, dtype=np.float64)
    denom = cm.sum(axis=-1, keepdims=True)
    return np.divide(cm, denom, out=np.zeros_like(cm), where=denom > 0)


def per_fret_accuracy(cm: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """[S, C, C] confusion -> ([S, C] per-fret accuracy, [S, C] support)
    (the 6 x 19 heatmap of bestengine.py:729-811)."""
    cm = np.asarray(cm, dtype=np.float64)
    support = cm.sum(axis=-1)
    diag = np.diagonal(cm, axis1=-2, axis2=-1)
    acc = np.divide(diag, support, out=np.zeros_like(diag), where=support > 0)
    return acc, support
