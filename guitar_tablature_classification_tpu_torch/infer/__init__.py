"""Batched transcription, ASCII tab rendering and the CLI."""

from .tab_text import format_tablature_text, format_time_table, write_tablature_file
from .transcribe import Transcriber, Transcription, transcriber_from_torch_checkpoint

__all__ = [
    "Transcriber", "Transcription", "format_tablature_text",
    "format_time_table", "transcriber_from_torch_checkpoint",
    "write_tablature_file",
]
