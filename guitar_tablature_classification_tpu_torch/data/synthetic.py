"""Synthetic GuitarSet-like fixtures: notes -> audio + JAMS + labels (a
copy of the JAX package's ``data/synthetic.py``: a seed gives the same
arrays bit for bit).

GuitarSet's WAV/JAMS payload is not redistributable with the reference
repo (its ``audio/`` and ``annotation/`` dirs are gitignored), so tests,
benchmarks and e2e demos synthesize physically plausible data instead: a
random performance is rendered as decaying-harmonic plucks (per string,
per fret) and emitted alongside its exact JAMS annotation dict, from
which the label extractor produces ``(6, 19)`` targets.  This closes the
loop: audio -> CQT -> model vs JAMS -> labels, with a learnable mapping.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..config import CQTConfig, NUM_FRETS, NUM_STRINGS, OPEN_STRING_MIDI


def midi_to_hz(midi: float) -> float:
    return 440.0 * 2.0 ** ((midi - 69.0) / 12.0)


def render_note(
    sr: int, duration: float, midi: float, *, harmonics: int = 6,
    decay: float = 3.0, amp: float = 0.3, detune_cents: float = 0.0,
    inharmonicity: float = 0.0, pluck: float = 0.0,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Decaying-harmonic pluck.  Robustness knobs (round-5 VERDICT #4 —
    all default 0.0 = the round-4 stats-calibrated rendering, bit-exact):

    - ``detune_cents``: shift f0 by this many cents (per-note tuning
      error; real GuitarSet players are within a few cents but never 0).
    - ``inharmonicity``: string-stiffness coefficient B — partial h
      sounds at ``f0*h*sqrt(1 + B*h^2)`` instead of the exact harmonic
      (steel strings: B ~ 1e-4..1e-3), smearing the CQT comb.
    - ``pluck``: amplitude of a ~8 ms broadband attack transient
      (pick/finger noise), drawn from ``rng``.
    """
    n = int(duration * sr)
    t = np.arange(n) / sr
    f0 = midi_to_hz(midi) * 2.0 ** (detune_cents / 1200.0)
    wave = np.zeros(n, dtype=np.float64)
    nyquist = sr / 2
    for h in range(1, harmonics + 1):
        f = f0 * h * math.sqrt(1.0 + inharmonicity * h * h)
        if f >= nyquist:
            break
        wave += (amp / h) * np.sin(2 * math.pi * f * t)
    env = np.exp(-decay * t) * np.minimum(t * 200.0, 1.0)  # attack + decay
    out = wave * env
    if pluck > 0.0 and n > 0:
        burst_n = min(n, max(1, int(0.008 * sr)))
        burst_rng = rng if rng is not None else np.random.default_rng(0)
        burst = burst_rng.standard_normal(burst_n)
        burst *= amp * pluck * np.exp(-np.arange(burst_n) / (0.002 * sr))
        out[:burst_n] += burst
    return out.astype(np.float32)


# Chord interval templates (semitones above the root): the voicing
# shapes of comp-style playing.  3-5 notes spanning up to ~2 octaves,
# so several pitches land in one first-fit string band per window —
# the source of the fixtures' ~48 % multi-mark frames.
_CHORD_TEMPLATES = (
    (0, 4, 7, 12, 16),   # major add-3rd-on-top
    (0, 3, 7, 12, 15),   # minor
    (0, 4, 10, 14, 19),  # dominant 9
    (0, 3, 10, 14, 17),  # m7 add 11
    (0, 7, 12, 16, 21),  # open fifth stack
    (0, 5, 10, 15, 19),  # quartal
)


def _physical_position(pitch: int, used: set[int]) -> tuple[int, int] | None:
    """Lowest-fret playable (string, fret) for a pitch, skipping strings
    already sounding (one pitch per physical string, like a guitarist)."""
    best = None
    for s in range(NUM_STRINGS):
        if s in used:
            continue
        fret = pitch - OPEN_STRING_MIDI[s]
        if 0 <= fret <= 15 and (best is None or fret < best[1]):
            best = (s, fret)
    return best


def random_performance(
    rng: np.random.Generator,
    duration: float = 4.0,
    *,
    notes_per_second: float | None = None,
    max_fret: int = 12,
    style: str = "guitarset",
) -> list[tuple[int, int, float, float]]:
    """-> list of (string, fret, onset, note_duration).

    ``style="guitarset"`` (default since round 4) renders a comp/solo-like
    performance — chord strums (sustained, 3-5 voices) interleaved with
    melodic runs and rests — whose labels under the shipped-fixture
    convention reproduce the measured statistics of the reference's
    ``tablatures/`` payload (~48 % multi-mark frames, declining
    per-string activity, ~8 % idle frames; see
    tests/test_data.py::test_synthetic_label_statistics_match_fixtures).
    ``style="sparse"`` (or passing ``notes_per_second``) keeps the
    round-1 generator: independent uniform single notes.
    """
    if style == "sparse" or notes_per_second is not None:
        nps = 3.0 if notes_per_second is None else notes_per_second
        events = []
        n_notes = max(1, int(duration * nps))
        for _ in range(n_notes):
            s = int(rng.integers(0, NUM_STRINGS))
            fret = int(rng.integers(0, min(max_fret + 1, NUM_FRETS)))
            onset = float(rng.uniform(0.0, duration - 0.3))
            dur = float(rng.uniform(0.2, min(1.5, duration - onset)))
            events.append((s, fret, onset, dur))
        return sorted(events, key=lambda e: e[2])
    if style != "guitarset":
        raise ValueError(f"unknown style {style!r}")

    events: list[tuple[int, int, float, float]] = []
    beat = float(rng.uniform(0.22, 0.38))  # ~160-270 bpm eighths
    melody = int(rng.integers(55, 72))
    t = float(rng.uniform(0.0, 0.1))
    while t < duration - 0.15:
        r = rng.random()
        if r < 0.24:  # chord strum (sustained)
            root = int(rng.integers(40, 53))
            tmpl = _CHORD_TEMPLATES[int(rng.integers(len(_CHORD_TEMPLATES)))]
            n_voices = int(rng.integers(2, 5))
            dur = float(rng.uniform(1.2, 3.2)) * beat
            used: set[int] = set()
            for iv in tmpl[:n_voices]:
                pos = _physical_position(root + iv, used)
                if pos is None:
                    continue
                used.add(pos[0])
                events.append(
                    (pos[0], pos[1], t, min(dur, duration - t - 0.01))
                )
        elif r < 0.80:  # melodic step (mean-reverting random walk)
            step = int(rng.integers(-4, 6)) - (melody - 62) // 5
            melody = int(np.clip(melody + step, 47, 75))
            pos = _physical_position(melody, set())
            if pos is not None:
                dur = float(rng.uniform(1.0, 2.4)) * beat
                events.append(
                    (pos[0], pos[1], t, min(dur, duration - t - 0.01))
                )
        # else: rest (no event this beat)
        t += beat * int(rng.choice((1, 1, 1, 2)))
    if not events:  # degenerate very-short durations
        events.append((0, 0, 0.0, max(duration - 0.05, 0.05)))
    return sorted(events, key=lambda e: e[2])


@dataclass(frozen=True)
class RenderConfig:
    """Recording-condition knobs for :func:`render_performance` (round-5
    VERDICT #4: harden the synthetic proxy toward GuitarSet's real
    recording conditions — hexaphonic pickups with bleed, pluck
    transients, player tuning error, room noise).  All-zero defaults
    reproduce the round-4 rendering bit-for-bit (same RNG stream).

    ``bleed`` is the mono-mix analogue of hexaphonic inter-string bleed
    (jam_to_tablature.py:360-367 consumes ``hex_debleeded`` files whose
    de-bleeding leaves residual cross-string content): each note also
    excites the OTHER five open strings sympathetically at this relative
    amplitude — spurious open-string pitch content a center classifier
    must reject."""

    noise: float = 1e-4          # additive white noise RMS
    detune_cents: float = 0.0    # per-note tuning error, uniform(+/- this)
    inharmonicity: float = 0.0   # string stiffness B (steel ~1e-4..1e-3)
    pluck: float = 0.0           # attack-transient amplitude (rel. note amp)
    bleed: float = 0.0           # sympathetic open-string level (rel.)

    @staticmethod
    def hardness(level: float) -> "RenderConfig":
        """Scalar 0..1 -> knob set; 1.0 is the 'hardest' studio-unfriendly
        setting used by the DESIGN robustness table."""
        level = float(level)
        return RenderConfig(
            noise=1e-4 + level * 3e-2,
            detune_cents=12.0 * level,
            inharmonicity=8e-4 * level,
            pluck=1.2 * level,
            bleed=0.12 * level,
        )


def render_performance(
    events, duration: float, cfg: CQTConfig | None = None,
    *, noise: float = 1e-4, seed: int = 0,
    render: RenderConfig | None = None,
) -> np.ndarray:
    """Mix a performance to mono.  ``render`` bundles the robustness
    knobs; when omitted, ``noise``/``seed`` keep the legacy signature
    (and the all-zero default knobs keep the output bit-identical to the
    round-4 generator for a given seed: the extra RNG streams are only
    created when a knob is active)."""
    rc = render if render is not None else RenderConfig(noise=noise)
    cfg = cfg or CQTConfig()
    sr = cfg.sample_rate
    out = np.zeros(int(duration * sr) + 1, dtype=np.float32)
    hard = (rc.detune_cents > 0 or rc.inharmonicity > 0 or rc.pluck > 0
            or rc.bleed > 0)
    note_rng = np.random.default_rng((seed << 8) ^ 0x5EED) if hard else None
    for s, fret, onset, dur in events:
        midi = OPEN_STRING_MIDI[s] + fret
        detune = (
            float(note_rng.uniform(-rc.detune_cents, rc.detune_cents))
            if hard and rc.detune_cents > 0 else 0.0
        )
        note = render_note(
            sr, dur, midi, detune_cents=detune,
            inharmonicity=rc.inharmonicity, pluck=rc.pluck, rng=note_rng,
        )
        lo = int(onset * sr)
        out[lo : lo + len(note)] += note
        if rc.bleed > 0.0:
            # sympathetic ringing of the other open strings: short,
            # faster-decaying, quiet — residual "bleed" pitch content
            for other in range(NUM_STRINGS):
                if other == s:
                    continue
                ring = render_note(
                    sr, min(dur, 0.35), float(OPEN_STRING_MIDI[other]),
                    harmonics=3, decay=9.0, amp=0.3 * rc.bleed,
                )
                out[lo : lo + len(ring)] += ring
    rng = np.random.default_rng(seed)
    out += rc.noise * rng.standard_normal(out.shape).astype(np.float32)
    peak = np.abs(out).max()
    if peak > 1.0:
        out /= peak
    return out[: int(duration * sr)]


def events_to_jams_dict(events, duration: float) -> dict:
    """The GuitarSet JAMS layout: six note_midi annotations keyed by
    data_source (0 = low E), MIDI note values."""
    per_string: list[list] = [[] for _ in range(NUM_STRINGS)]
    for s, fret, onset, dur in events:
        per_string[s].append(
            {
                "time": onset,
                "duration": dur,
                "value": float(OPEN_STRING_MIDI[s] + fret),
                "confidence": None,
            }
        )
    return {
        "file_metadata": {"duration": duration},
        "annotations": [
            {
                "namespace": "note_midi",
                "annotation_metadata": {"data_source": str(s)},
                "data": data,
            }
            for s, data in enumerate(per_string)
        ],
    }


def make_synthetic_dataset(
    rng: np.random.Generator,
    num_tracks: int = 4,
    duration: float = 4.0,
    cfg: CQTConfig | None = None,
    render: RenderConfig | None = None,
) -> list[dict]:
    """-> per-track dicts {audio, jams, events, duration}."""
    cfg = cfg or CQTConfig()
    tracks = []
    for i in range(num_tracks):
        events = random_performance(rng, duration)
        audio = render_performance(events, duration, cfg, seed=i,
                                   render=render)
        tracks.append(
            {
                "name": f"synth{i:02d}_comp",
                "audio": audio,
                "jams": events_to_jams_dict(events, duration),
                "events": events,
                "duration": duration,
            }
        )
    return tracks
