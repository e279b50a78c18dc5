"""MIDI pitch -> (string, fret) tablature matrices: a copy of the JAX
package's ``labels/tablature.py`` (the port imports nothing of it).

Three conventions coexist in the reference lineage:

1. ``first_fit_window`` — the convention of the SHIPPED
   ``tablatures/*.npy`` fixtures (SURVEY C16), pinned in round 4 by the
   fixtures' own support: pool the pitches of every note whose
   [onset, onset+duration) overlaps the 0.2 s window, assign each pitch
   to the FIRST string s (scanning 0 = low E upward) where
   ``fret = round(midi - open_midi[s])`` lands in [0, 18], and mark
   fret 0 on strings left idle.  The reachable (string, fret) support of
   this rule — string 0: frets 0-18 (midi 40-58); strings 1-3: {0,
   14-18}; string 4: {0, 15-18} (midi 73 still fits string 3); string 5:
   {0, 14-18} — contains EVERY mark in all 43,188 shipped fixtures
   (tests/test_labels.py::test_fixture_support_matches_first_fit), while
   the per-string reading (2.) would populate strings 1-5 at frets 1-13
   (the most-played positions), which are empty in every fixture.

   The TIMING rule (round 5, tools/probe_label_timing.py): window
   pooling — not the center-instant query both reference extractor
   revisions use (jam_to_tablature.py:273-274,
   ``new_dataset (1).py:692-695``) — is pinned by per-frame
   distinct-pitch counts: GuitarSet's note_midi annotations are
   monophonic per string, so a center-instant snapshot can sound at
   most 6 pitches and mark at most 6 distinct fret>=1 cells, yet 258
   shipped frames carry 7-11 distinct cells (chord changes pooled
   inside the window).  Run-length statistics alone could NOT have
   decided this: cell [a, a+0.2) intersects a note iff the center
   a+0.1 lies in the note dilated +-0.1 s, so window-overlap labels
   equal center-instant labels under a +0.2 s duration shift — any
   run-length distribution fits both hypotheses.
   Remaining DOF: the fret quantization ``int(round(midi - open))`` is
   fixture-UNDECIDABLE (round vs floor reach the identical support set;
   only band boundaries shift, and GuitarSet pitches cluster within
   +-0.3 semitones of integers) but is pinned by reference code — both
   revisions use ``int(round(...))`` (jam_to_tablature.py:95).

2. ``per_string_window`` — the direct reading of GuitarSet's per-string
   annotations (round 1-3 default): every note of string s's annotation
   overlapping the window marks ``round(midi - open_midi[s])`` on row s;
   idle rows get fret 0.  Kept as the musically-faithful convention (the
   fixture support proves the shipped labels were NOT generated this
   way).

3. ``lowest_fret_center`` — jam_to_tablature.py:55-143: pool all notes
   active at the window *center* across strings, then map each pitch to
   the valid (string, fret) with the lowest fret; idle strings stay
   all-zero.
"""

from __future__ import annotations

import numpy as np

from ..config import NUM_FRETS, NUM_STRINGS, OPEN_STRING_MIDI
from .jams_io import Jams, hz_to_midi, note_value_to_midi


def empty_tablature() -> np.ndarray:
    return np.zeros((NUM_STRINGS, NUM_FRETS), dtype=np.int8)


def tablature_per_string_window(
    jam: Jams, start: float, window: float = 0.2
) -> np.ndarray:
    """The per-string direct reading of GuitarSet's annotations (the
    rounds 1-3 default): every note of string s's annotation overlapping
    the window marks its fret on row s; idle rows get fret 0.  NOT the
    shipped-fixture convention — the fixtures' (string, fret) support
    proves they were generated by first-fit pooling instead (see module
    docstring and ``tablature_first_fit_window``)."""
    tab = empty_tablature()
    end = start + window
    anns = jam.string_annotations("note_midi")
    for s, ann in enumerate(anns[:NUM_STRINGS]):
        marked = False
        for obs in ann.observations:
            if obs.time < end and obs.time + obs.duration > start:
                midi = note_value_to_midi(obs.value)
                if midi is None:
                    continue
                fret = int(round(midi - OPEN_STRING_MIDI[s]))
                if 0 <= fret < NUM_FRETS:
                    tab[s, fret] = 1
                    marked = True
        if not marked:
            tab[s, 0] = 1  # open/idle marker
    return tab


def midi_to_tablature_first_fit(midi_pitches) -> np.ndarray:
    """Each pitch goes to the FIRST string (low E upward) whose fret
    fits [0, 18]; pitches outside every string's range are dropped.
    The shipped-fixture mapping rule (see module docstring)."""
    tab = empty_tablature()
    for pitch in midi_pitches:
        midi = note_value_to_midi(pitch)
        if midi is None:
            continue
        for s, open_midi in enumerate(OPEN_STRING_MIDI):
            fret = int(round(midi - open_midi))
            if 0 <= fret < NUM_FRETS:
                tab[s, fret] = 1
                break
    return tab


def tablature_first_fit_window(
    jam: Jams, start: float, window: float = 0.2
) -> np.ndarray:
    """The shipped-fixture convention: window-overlap pitch pooling
    across all note_midi annotations, first-fit string assignment,
    fret 0 on idle strings (every row carries >= 1 mark)."""
    end = start + window
    pitches = []
    for ann in jam.by_namespace("note_midi"):
        for obs in ann.observations:
            if obs.time < end and obs.time + obs.duration > start:
                pitches.append(obs.value)
    tab = midi_to_tablature_first_fit(pitches)
    idle = tab.sum(axis=1) == 0
    tab[idle, 0] = 1
    return tab


def midi_to_tablature_lowest_fret(
    midi_pitches, confidences=None
) -> np.ndarray:
    """jam_to_tablature.py:55-109: each pitch goes to the valid position
    with the lowest fret; confidence < 0.5 is skipped."""
    tab = empty_tablature()
    for i, pitch in enumerate(midi_pitches):
        conf = 1.0 if confidences is None else confidences[i]
        if conf is None or conf < 0.5:
            continue
        midi = note_value_to_midi(pitch)
        if midi is None:
            continue
        positions = []
        for s, open_midi in enumerate(OPEN_STRING_MIDI):
            fret = int(round(midi - open_midi))
            if 0 <= fret < NUM_FRETS:
                positions.append((fret, s))
        if positions:
            fret, s = min(positions)
            tab[s, fret] = 1
    return tab


def tablature_lowest_fret_center(jam: Jams, center: float) -> np.ndarray:
    """jam_to_tablature.py:110-143: all note_midi notes active at the
    center instant, mapped with lowest-fret preference."""
    pitches = []
    for ann in jam.by_namespace("note_midi"):
        for obs in ann.observations:
            if obs.time <= center < obs.time + obs.duration:
                pitches.append(obs.value)
    return midi_to_tablature_lowest_fret(pitches)


def tablature_from_pitch_contour(
    jam: Jams, center: float, tolerance: float = 0.05
) -> np.ndarray:
    """Fallback via pitch_contour within +/-50 ms
    (jam_to_tablature.py:145-178)."""
    pitches, confs = [], []
    for ann in jam.by_namespace("pitch_contour"):
        for obs in ann.observations:
            if abs(obs.time - center) < tolerance:
                value = obs.value
                if isinstance(value, dict):
                    value = value.get("frequency", value.get("value"))
                try:
                    freq = float(value)
                except (TypeError, ValueError):
                    continue
                if freq > 0:
                    pitches.append(hz_to_midi(freq))
                    confs.append(
                        1.0 if obs.confidence is None else obs.confidence
                    )
    return midi_to_tablature_lowest_fret(pitches, confs)


def tablature_to_frets(tab: np.ndarray) -> np.ndarray:
    """(.., 6, 19) one/multi-hot -> (.., 6) int fret targets via argmax —
    the training-label convention (my_dataloader.py:40-44): ties and
    multi-marks resolve to the LOWEST marked fret."""
    return np.argmax(np.asarray(tab), axis=-1)
