"""Rendered tablature images and per-string activation plots (the JAX
package's ``infer/tab_image.py``).

The tab image is the reference's tab-image writer
(tablature_generator.py:739-839): horizontal string lines (high e on top),
a time ruler, and fret numbers drawn in circles at their window positions,
wrapping to several rows for long tracks.  PIL and matplotlib are imported
inside the functions that use them, so importing this module (and the
``infer`` package) needs neither.
"""

from __future__ import annotations

import numpy as np

from .tab_text import STRING_NAMES


def _font(size: int):
    from PIL import ImageFont

    for name in (
        "DejaVuSansMono.ttf",
        "DejaVuSans.ttf",
        "/usr/share/fonts/truetype/dejavu/DejaVuSansMono.ttf",
    ):
        try:
            return ImageFont.truetype(name, size)
        except OSError:
            continue
    return ImageFont.load_default()


def create_tablature_image(
    frets: np.ndarray,
    times: np.ndarray,
    output_path: str,
    *,
    title: str | None = None,
    width: int = 1600,
    line_height: int = 40,
    cols_per_row: int = 32,
) -> str:
    """frets: [T, 6] (string 0 = low E).  Writes a PNG; returns its path."""
    from PIL import Image, ImageDraw

    frets = np.asarray(frets)
    t = frets.shape[0]
    rows = max(1, -(-t // cols_per_row))
    margin = 60
    header = 60 if title else 20
    row_height = line_height * 7 + 30
    height = header + rows * row_height + margin

    img = Image.new("RGB", (width, height), "white")
    draw = ImageDraw.Draw(img)
    font = _font(14)
    small = _font(11)
    if title:
        draw.text((margin, 15), title, fill="black", font=_font(20))

    col_width = (width - 2 * margin) / cols_per_row
    for row in range(rows):
        y0 = header + row * row_height + 20
        for s in range(6):  # string lines and names
            y = y0 + s * line_height
            draw.line([(margin, y), (width - margin, y)], fill="black")
            draw.text((margin - 30, y - 7), STRING_NAMES[s][0], fill="black", font=font)
        for c in range(cols_per_row):  # the windows of this row
            idx = row * cols_per_row + c
            if idx >= t:
                break
            x = margin + (c + 0.5) * col_width
            if c % 4 == 0:  # time ruler tick every 4 columns
                draw.text((x - 12, y0 - 18), f"{times[idx]:.1f}s", fill="gray", font=small)
            for display_row in range(6):
                fret = int(frets[idx, 5 - display_row])  # high e on top
                if fret == 0:
                    continue
                y = y0 + display_row * line_height
                r = 11
                draw.ellipse([(x - r, y - r), (x + r, y + r)], fill="white", outline="black")
                text = str(fret)
                tw = draw.textlength(text, font=font)
                draw.text((x - tw / 2, y - 8), text, fill="black", font=font)

    img.save(output_path)
    return output_path


def plot_string_activations(frets: np.ndarray, times: np.ndarray, output_path: str) -> str:
    """Per-string step plots (tablature-generator (1).py:522-555)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    frets = np.asarray(frets)
    fig, axes = plt.subplots(6, 1, figsize=(12, 10), sharex=True)
    for s, ax in enumerate(axes):
        display = 5 - s
        ax.step(times, frets[:, display], where="post")
        ax.set_ylabel(STRING_NAMES[s][0])
        ax.set_ylim(-1, 19)
        ax.grid(alpha=0.3)
    axes[-1].set_xlabel("time (s)")
    fig.suptitle("Per-string fret activations")
    fig.tight_layout()
    fig.savefig(output_path, dpi=100)
    plt.close(fig)
    return output_path
