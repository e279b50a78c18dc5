"""ASCII tablature rendering.

Reproduces the reference's text format (tablature_generator.py:926-975):
string lines in standard notation order (high e on top — the per-string
prediction order is reversed), '-' for open strings, fret numbers padded
to a 3-char cell, '|' terminators, optional time-marker header.  The
time-indexed table of tablature-generator (1).py:439-520 is also
provided (with its dead ``torch.datetime`` crash at :455 fixed to a real
timestamp).
"""

from __future__ import annotations

import datetime

import numpy as np

STRING_NAMES = ("e|", "B|", "G|", "D|", "A|", "E|")  # high to low


def format_tablature_text(
    frets: np.ndarray, timings=None
) -> str:
    """frets: [T, 6] int (string 0 = low E, the model/label order)."""
    frets = np.asarray(frets)
    lines = []
    if timings is not None:
        lines.append("  " + "  ".join(f"{t:.1f}s" for t in timings))
    for display_row in range(6):
        source = 5 - display_row  # reversed: high e first
        cells = []
        for t in range(frets.shape[0]):
            fret = int(frets[t, source])
            text = "-" if fret == 0 else str(fret)
            cells.append(f"{text}--" if len(text) == 1 else f"{text}-")
        lines.append(STRING_NAMES[display_row] + "".join(cells) + "|")
    return "\n".join(lines) + "\n"


def format_time_table(frets: np.ndarray, timings) -> str:
    """Per-window table: time + the fret sounding on each string
    (tablature-generator (1).py:474-506 layout)."""
    frets = np.asarray(frets)
    header = (
        f"{'Time':>7} | "
        + " ".join(f"{name[0]:>3}" for name in reversed(STRING_NAMES))
        + "\n"
    )
    rows = []
    for t, time_s in zip(range(frets.shape[0]), timings):
        cells = " ".join(
            f"{int(frets[t, 5 - i]):>3}" for i in range(6)
        )
        rows.append(f"{time_s:6.2f}s | {cells}")
    return header + "\n".join(rows) + "\n"


def write_tablature_file(
    path: str,
    frets: np.ndarray,
    timings,
    *,
    title: str | None = None,
    include_table: bool = True,
) -> str:
    parts = []
    if title:
        parts.append(f"Guitar Tablature: {title}")
    parts.append(f"Generated: {datetime.datetime.now():%Y-%m-%d %H:%M:%S}")
    parts.append("")
    parts.append(format_tablature_text(frets, None))
    if include_table:
        parts.append("")
        parts.append(format_time_table(frets, timings))
    text = "\n".join(parts)
    with open(path, "w") as f:
        f.write(text)
    return text
