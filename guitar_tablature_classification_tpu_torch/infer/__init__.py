"""Batched and streaming transcription, ASCII tab rendering, tab images and
activation plots, and the CLI."""

from .streaming import StreamingTranscriber
from .tab_image import create_tablature_image, plot_string_activations
from .tab_text import format_tablature_text, format_time_table, write_tablature_file
from .transcribe import Transcriber, Transcription, transcriber_from_torch_checkpoint

__all__ = [
    "StreamingTranscriber", "Transcriber", "Transcription", "create_tablature_image",
    "format_tablature_text", "format_time_table", "plot_string_activations",
    "transcriber_from_torch_checkpoint", "write_tablature_file",
]
