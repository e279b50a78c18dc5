"""The numbers that decide ``correct``, each from the port's output and
the reference's readings of the same inputs.

Training (the first ``check_steps`` steps through the window's own call
and feed; the port read through its model's parameters only).  Adam's
first update moves each weight by the learning rate against the sign of
its gradient (weight decay included), so the change of step 1 gives the
direction of each leaf's gradient; a leaf's direction error is
1 - cos(change_port, change_ref) of that change, 1 where either side did
not move:

- ``logit_direction_error``: the median over the strings' output layers'
  weights of the direction error.  It reads the whole forward (CQT,
  preprocess, trunk or blocks with their kernels, heads) and the loss;
- ``direction_error``: the worst leaf's direction error.  It reads every
  leaf's backward, the kernels' backward passes among them (a backward
  that returns nothing leaves the leaves under it moved by weight decay
  alone, reading about 1);
- ``change_gap``: the median leaf's gap |port| - |ref| of the norms of the
  parameters' change over the steps, over the larger of that leaf's
  reference norm and the median leaf's (a state left unchanged reads 1).

Each reads the leaves whose step-1 reference gradient is at least a
thousandth of the median leaf's (a gradient that is nought to rounding, as
a key's or a pre-BatchNorm bias's, moves under Adam by round-off alone).
Beside them (:func:`train_detail`) each step's loss gap, the gradient
norm's gap and the spread of the direction errors and change gaps over the
leaves are read and printed; ``PERF.md`` gives their readings and why they
are not compared.

Serving (a sample of the window's tracks, drawn from the seed, the longest
among them):

- ``fret_gap``: the widest gap by which the reference's logit of the
  port's top fret lies under the reference's best, over the RMS of the
  reference's logits, at every window and string;
- ``frets_mismatch``: windows and strings where the served frets are not
  the mode filter (window ``smooth_window``, ties to the lower fret) of
  the port's own logits' argmax, plus every window missing or extra;
- ``logit_error``: the RMS over every window, string and fret of the gap
  between the port's logit and the reference's, over the same RMS.  It
  reads rounding where the top fret lies far above the runner-up in most
  windows, as a random-weight model's can, and ``fret_gap`` reads little;
  being a mean, a rare large gap (a CQT feature on the other side of the
  -60 dB gate) moves it less than rounding everywhere does.

A cell compares the numbers its ``limits/<cell>.json`` names.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaf_gaps(port: dict, ref: dict, names: list[str]) -> np.ndarray:
    median = float(np.median([ref[n] for n in names]))
    return np.array([abs(port[n] - ref[n]) / max(ref[n], median, 1e-30) for n in names])


def _moved(ref: dict) -> list[str]:
    names = list(ref["grad"])
    g_median = float(np.median([ref["grad"][n] for n in names]))
    return [n for n in names if ref["grad"][n] >= 1e-3 * g_median]


def direction_errors(port: dict, ref: dict, names: list[str]) -> np.ndarray:
    """1 - cos of each leaf's step-1 change, port against reference."""
    out = []
    for n in names:
        a, b = port[n].double().reshape(-1), ref[n].double().reshape(-1)
        norms = float(torch.linalg.vector_norm(a) * torch.linalg.vector_norm(b))
        out.append(1.0 - float(a @ b) / norms if norms > 0 else 1.0)
    return np.array(out)


def train_numbers(port: dict, ref: dict) -> dict[str, float]:
    moved = _moved(ref)
    return {"logit_direction_error": float(np.median(
                direction_errors(port["step1"], ref["step1"], ref["logit_weights"]))),
            "direction_error": float(direction_errors(port["step1"], ref["step1"], moved).max()),
            "change_gap": float(np.median(_leaf_gaps(port["change"], ref["change"], moved)))}


def train_detail(port: dict, ref: dict) -> dict:
    """Readings beside :func:`train_numbers`: every step's loss gap, the
    global gradient norm's gap, and over the moved leaves the direction
    errors and the gaps of the change's norms: [median, 90th percentile,
    worst, the worst leaf's name]."""
    out = {"loss_steps": [abs(p - r) / abs(r) for p, r in zip(port["loss"], ref["loss"])],
           "grad_norm": abs(port["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]}
    moved = _moved(ref)
    for key, values in (("direction", direction_errors(port["step1"], ref["step1"], moved)),
                        ("change", _leaf_gaps(port["change"], ref["change"], moved))):
        out[key] = [float(np.median(values)), float(np.percentile(values, 90)),
                    float(values.max()), moved[int(values.argmax())]]
    return out


def mode_filter(preds: np.ndarray, window: int, classes: int) -> np.ndarray:
    """Each window's value becomes the most common in its +/- window//2
    neighbourhood (zero padded outside the track), the lowest on a tie;
    tracks of at most ``window`` windows stay as they are."""
    t = preds.shape[0]
    if t <= window:
        return preds.copy()
    half = window // 2
    votes = np.zeros(preds.shape + (classes,), np.int64)
    for s in range(-half, half + 1):
        lo, hi = max(0, -s), min(t, t - s)
        np.add.at(votes, (np.arange(lo, hi)[:, None], np.arange(preds.shape[1])[None, :],
                          preds[lo + s:hi + s]), 1)
    return votes.argmax(-1)


def serve_numbers(served: list[tuple[np.ndarray, np.ndarray]], ref_logits: list[np.ndarray],
                  smooth_window: int) -> dict[str, float]:
    """``served``: (frets, logits) of each sampled track as the port
    returned them; ``ref_logits``: the reference's logits of its windows."""
    gaps, sq, sq_diff, count, mismatch = [], 0.0, 0.0, 0, 0
    for (frets, logits), ref in zip(served, ref_logits):
        if logits.shape != ref.shape or frets.shape != ref.shape[:2]:
            mismatch += ref.shape[0] * ref.shape[1]
            continue
        top = logits.argmax(-1)
        chosen = np.take_along_axis(ref, top[..., None], -1)[..., 0]
        gaps.append(float((ref.max(-1) - chosen).max()))
        sq += float((ref.astype(np.float64) ** 2).sum())
        sq_diff += float(((logits.astype(np.float64) - ref) ** 2).sum())
        count += ref.size
        mismatch += int((frets != mode_filter(top, smooth_window, ref.shape[-1])).sum())
    rms = (sq / count) ** 0.5 if count else 1.0
    return {"fret_gap": max(gaps, default=float("inf")) / rms, "frets_mismatch": float(mismatch),
            "logit_error": (sq_diff / count) ** 0.5 / rms if count else float("inf")}


def control_numbers(ref_logits: list[np.ndarray], low: list[np.ndarray],
                    smooth_window: int) -> dict[str, float]:
    """:func:`serve_numbers` of a lower-precision computation (``low``) of
    the same windows served in the port's place: the control's readings."""
    served = [(mode_filter(x.argmax(-1), smooth_window, x.shape[-1]), x) for x in low]
    return serve_numbers(served, ref_logits, smooth_window)
