"""Training/eval visualization suite (Matplotlib, Agg backend)."""

from .plots import (
    render_spectrogram_png,
    plot_confusion_matrices,
    plot_correct_incorrect_distribution,
    parameter_counts,
    plot_model_architecture,
    plot_per_fret_accuracy,
    plot_prediction_overlay,
    plot_sample_inputs,
    plot_training_metrics,
)

__all__ = [
    "render_spectrogram_png",
    "plot_confusion_matrices",
    "plot_correct_incorrect_distribution",
    "parameter_counts",
    "plot_model_architecture",
    "plot_per_fret_accuracy",
    "plot_prediction_overlay",
    "plot_sample_inputs",
    "plot_training_metrics",
]
