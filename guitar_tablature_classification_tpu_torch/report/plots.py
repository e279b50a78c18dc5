"""Training/eval visualization suite (the JAX package's
``report/plots.py``).

Covers the reference's C13 artifact set (SURVEY §2): training metric
curves (bestengine.py:302-328, 814-865), sample-input grids (:435-475),
prediction overlays (:478-535), correct/incorrect distributions
(:538-605), row-normalized confusion-matrix heatmaps (:608-686),
parameter-count bars (:689-726) and the 6x19 per-fret accuracy heatmap
with support counts (:729-811).  All functions render to files via the
Agg backend (headless-safe) and return the path.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


STRING_LABELS = ("E (low)", "A", "D", "G", "B", "e (high)")


def plot_training_metrics(history: Mapping[str, Sequence], path: str) -> str:
    """Loss / accuracy / LR curves over epochs."""
    plt = _plt()
    fig, axes = plt.subplots(1, 3, figsize=(16, 4.5))
    epochs = np.arange(1, len(history["train_loss"]) + 1)

    axes[0].plot(epochs, history["train_loss"], label="train")
    axes[0].plot(epochs, history["val_loss"], label="val")
    axes[0].set_title("loss"), axes[0].set_xlabel("epoch"), axes[0].legend()

    per_string = np.asarray(history.get("val_per_string", []))
    if per_string.size:
        for s in range(per_string.shape[1]):
            axes[1].plot(epochs, per_string[:, s], label=STRING_LABELS[s])
        axes[1].legend(fontsize=7)
    if history.get("val_accuracy"):
        axes[1].plot(
            epochs, history["val_accuracy"], "k--", lw=2, label="overall"
        )
    axes[1].set_title("val accuracy"), axes[1].set_xlabel("epoch")

    if history.get("lr"):
        axes[2].semilogy(epochs, history["lr"])
    axes[2].set_title("learning rate"), axes[2].set_xlabel("epoch")

    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_sample_inputs(
    features: np.ndarray, path: str, *, labels: np.ndarray | None = None,
    max_samples: int = 8,
) -> str:
    """Grid of CQT inputs (bestengine.py:435-475)."""
    plt = _plt()
    n = min(len(features), max_samples)
    cols = min(4, n)
    rows = -(-n // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 3 * rows),
                             squeeze=False)
    for i in range(rows * cols):
        ax = axes[i // cols][i % cols]
        if i < n:
            ax.imshow(np.asarray(features[i]), aspect="auto", origin="lower",
                      cmap="magma")
            if labels is not None:
                ax.set_title(f"frets {np.asarray(labels[i]).tolist()}",
                             fontsize=8)
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_prediction_overlay(
    features: np.ndarray, preds: np.ndarray, targets: np.ndarray, path: str,
    *, max_samples: int = 6,
) -> str:
    """Inputs with per-string ✓/✗ prediction annotations
    (bestengine.py:478-535)."""
    plt = _plt()
    n = min(len(features), max_samples)
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 4), squeeze=False)
    for i in range(n):
        ax = axes[0][i]
        ax.imshow(np.asarray(features[i]), aspect="auto", origin="lower",
                  cmap="magma")
        lines = []
        for s in range(6):
            p, t = int(preds[i][s]), int(targets[i][s])
            mark = "✓" if p == t else "✗"
            lines.append(f"{STRING_LABELS[s][0]}: {p}/{t} {mark}")
        ax.set_title("\n".join(lines), fontsize=7, family="monospace")
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_correct_incorrect_distribution(
    preds: np.ndarray, targets: np.ndarray, path: str
) -> str:
    """Per-string correct/incorrect bars (bestengine.py:538-605)."""
    plt = _plt()
    preds, targets = np.asarray(preds), np.asarray(targets)
    correct = (preds == targets).sum(axis=0)
    incorrect = (preds != targets).sum(axis=0)
    x = np.arange(6)
    fig, ax = plt.subplots(figsize=(9, 4.5))
    ax.bar(x - 0.2, correct, 0.4, label="correct", color="#2a9d8f")
    ax.bar(x + 0.2, incorrect, 0.4, label="incorrect", color="#e76f51")
    ax.set_xticks(x, STRING_LABELS)
    ax.set_ylabel("windows")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_confusion_matrices(cm: np.ndarray, path: str) -> str:
    """Six row-normalized fret confusion heatmaps (bestengine.py:608-686)."""
    plt = _plt()
    from ..train.metrics import row_normalize

    cm = row_normalize(cm)
    fig, axes = plt.subplots(2, 3, figsize=(16, 10))
    for s, ax in enumerate(axes.flat):
        im = ax.imshow(cm[s], vmin=0, vmax=1, cmap="viridis")
        ax.set_title(STRING_LABELS[s])
        ax.set_xlabel("predicted fret"), ax.set_ylabel("true fret")
    fig.colorbar(im, ax=axes, shrink=0.7)
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_per_fret_accuracy(
    acc: np.ndarray, support: np.ndarray, path: str
) -> str:
    """6x19 accuracy heatmap with n= annotations (bestengine.py:729-811)."""
    plt = _plt()
    acc, support = np.asarray(acc), np.asarray(support)
    fig, ax = plt.subplots(figsize=(16, 5))
    im = ax.imshow(acc, vmin=0, vmax=1, cmap="RdYlGn", aspect="auto")
    for s in range(acc.shape[0]):
        for f in range(acc.shape[1]):
            if support[s, f] > 0:
                ax.text(
                    f, s, f"{acc[s, f]:.2f}\nn={int(support[s, f])}",
                    ha="center", va="center", fontsize=6,
                )
    ax.set_yticks(range(6), STRING_LABELS)
    ax.set_xticks(range(acc.shape[1]))
    ax.set_xlabel("fret"), ax.set_title("per-fret accuracy")
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def render_spectrogram_png(feature: np.ndarray, path: str) -> str:
    """Axis-less spectrogram PNG — the new_cqt.py:36-42 specshow artifact.

    In this framework models consume raw arrays; the PNG rendering
    capability survives only here, for inspection and for users who kept
    PNG-based tooling."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(3, 3))
    ax.imshow(np.asarray(feature), aspect="auto", origin="lower", cmap="magma")
    ax.axis("off")
    fig.subplots_adjust(left=0, right=1, top=1, bottom=0)
    fig.savefig(path, dpi=75)
    plt.close(fig)
    return path


def parameter_counts(model) -> dict[str, int]:
    """{top-level module: parameter count} of a ``torch.nn.Module``, the
    parameters grouped by the first component of their dotted names.  Only
    parameters count: BatchNorm's running statistics are buffers here, as
    they are ``batch_stats`` (not ``params``) in the Flax models."""
    sizes: dict[str, int] = {}
    for name, p in model.named_parameters():
        top = name.split(".")[0]
        sizes[top] = sizes.get(top, 0) + p.numel()
    return sizes


def plot_model_architecture(model, path: str) -> str:
    """Horizontal parameter-count bars per top-level module
    (bestengine.py:689-726); see :func:`parameter_counts`."""
    plt = _plt()
    sizes = parameter_counts(model)
    names = list(sizes)
    counts = [sizes[n] for n in names]
    fig, ax = plt.subplots(figsize=(9, 0.5 * len(names) + 2))
    ax.barh(names, counts, color="#457b9d")
    ax.set_xlabel("parameters")
    total = sum(counts)
    ax.set_title(f"total parameters: {total:,}")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
