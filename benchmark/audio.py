"""Guitar-like audio from the seed: plucked notes on the six strings'
pitches, rendered on the device in bulk.

A track is a run of notes starting every 0.2-0.6 s, each on a random
string (open pitch E2 A2 D3 G3 B3 E4) and fret 0-12: five harmonics at
1/h amplitude (those under Nyquist), decaying with a 0.5 s time constant
over 1.5 s, at 0.3; plus noise at 0.003.  This is ``chip_smoke.py``'s
``synthetic_track`` with the note schedule drawn on the host and all the
notes summed on the device in one scatter.  The schedule also gives each
window its labels, as a tablature would: per string, the fret of the
latest note still sounding at the window's centre, 0 where none is (fret 0
doubles as "open or silent").
"""

from __future__ import annotations

import numpy as np
import torch

from .seeds import derive

OPEN_STRINGS = (40, 45, 50, 55, 59, 64)


NOTE_SECONDS = 1.5


def tracks(seconds: list[float], sr: int, seed: int, device,
           schedules: list | None = None) -> list[torch.Tensor]:
    """One float32 track on ``device`` per entry of ``seconds``; with
    ``schedules`` (a list), each track's notes are appended to it as
    (start sample, string, fret) arrays."""
    rng = np.random.default_rng(derive(seed, "notes"))
    gen = torch.Generator(device=device).manual_seed(derive(seed, "noise"))
    note_len = int(NOTE_SECONDS * sr)
    tt = torch.arange(note_len, device=device, dtype=torch.float32) / sr
    env = torch.exp(-tt / 0.5)
    out = []
    for length in seconds:
        n = int(length * sr)
        starts, f0s, strings, frets, t0 = [], [], [], [], 0.0
        while t0 < length:
            string, fret = int(rng.integers(6)), int(rng.integers(0, 13))
            midi = OPEN_STRINGS[string] + fret
            starts.append(int(t0 * sr))
            strings.append(string)
            frets.append(fret)
            f0s.append(440.0 * 2.0 ** ((midi - 69) / 12.0))
            t0 += rng.uniform(0.2, 0.6)
        if schedules is not None:
            schedules.append((np.array(starts), np.array(strings), np.array(frets)))
        f0 = torch.tensor(f0s, device=device, dtype=torch.float32)[:, None]
        notes = torch.zeros(len(f0s), note_len, device=device)
        for h in range(1, 6):
            notes += torch.sin(2 * np.pi * h * f0 * tt) / h * (h * f0 < sr / 2)
        notes *= 0.3 * env  # [notes, note_len]
        idx = torch.tensor(starts, device=device)[:, None] + torch.arange(note_len, device=device)
        keep = idx < n
        audio = torch.zeros(n, device=device)
        for j in range(8):  # notes j, j+8, ... lie 1.6 s apart: no index twice, no race
            audio.index_add_(0, idx[j::8][keep[j::8]], notes[j::8][keep[j::8]])
        audio += 0.003 * torch.randn(n, generator=gen, device=device)
        out.append(audio)
    return out


def labels(schedule, centres: np.ndarray, sr: int) -> np.ndarray:
    """[windows, 6] frets at the sample positions ``centres``."""
    starts, strings, frets = schedule
    out = np.zeros((len(centres), len(OPEN_STRINGS)), np.int64)
    for start, string, fret in zip(starts, strings, frets):  # in time order: later notes win
        sounding = (centres >= start) & (centres < start + int(NOTE_SECONDS * sr))
        out[sounding, string] = fret
    return out


def train_batches(traffic: dict, window: int, hop: int, sr: int, seed: int, device) -> list[dict]:
    """``traffic["batches"]`` host batches of ``traffic["batch"]`` windows,
    cut at ``hop`` from one rendered track, all rows distinct, with the
    track's own labels: [{"audio", "labels"}] of NumPy arrays in host
    memory; the batches mix the track's parts."""
    count, batch = traffic["batches"], traffic["batch"]
    rows = count * batch
    schedule: list = []
    (track,) = tracks([(window + (rows - 1) * hop) / sr + 0.01], sr, seed, device, schedule)
    starts = torch.arange(rows, device=device)[:, None] * hop
    windows = track[starts + torch.arange(window, device=device)].cpu().numpy()
    frets = labels(schedule[0], np.arange(rows) * hop + window // 2, sr)
    perm = np.random.default_rng(derive(seed, "batches")).permutation(rows)
    return [{"audio": np.ascontiguousarray(windows[perm[i * batch:(i + 1) * batch]]),
             "labels": frets[perm[i * batch:(i + 1) * batch]]} for i in range(count)]
