"""Minimal JAMS reader (plain JSON, no ``jams`` dependency): a copy of
the JAX package's ``labels/jams_io.py``.

The reference parses GuitarSet annotation files with the ``jams`` library
(jam_to_tablature.py:110-178).  A JAMS file is just JSON with a fixed
schema; this module loads the two namespaces the pipeline needs —
``note_midi`` (per-string note events in GuitarSet: six annotations with
``data_source`` "0".."5", low E string to high e) and ``pitch_contour``
(the fallback namespace) — into plain dataclasses.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class Observation:
    time: float
    duration: float
    value: Any
    confidence: float | None


@dataclass(frozen=True)
class Annotation:
    namespace: str
    data_source: str | None
    observations: tuple[Observation, ...]


@dataclass(frozen=True)
class Jams:
    annotations: tuple[Annotation, ...]
    duration: float | None

    def by_namespace(self, namespace: str) -> list[Annotation]:
        return [a for a in self.annotations if a.namespace == namespace]

    def string_annotations(self, namespace: str = "note_midi") -> list[Annotation]:
        """The 6 per-string annotations ordered by data_source (0 = low E).

        Falls back to file order when data_source is missing.
        """
        anns = self.by_namespace(namespace)

        def key(pair):
            idx, ann = pair
            try:
                return (0, int(ann.data_source), idx)
            except (TypeError, ValueError):
                return (1, 0, idx)

        return [a for _, a in sorted(enumerate(anns), key=key)]


def _float_or_none(x) -> float | None:
    try:
        return float(x)
    except (TypeError, ValueError):
        return None


def _parse_observation(entry) -> Observation:
    if isinstance(entry, dict):
        return Observation(
            time=float(entry.get("time", 0.0)),
            duration=float(entry.get("duration") or 0.0),
            value=entry.get("value"),
            confidence=_float_or_none(entry.get("confidence")),
        )
    # list-form observations: [time, duration, value, confidence]
    time, duration, value = entry[0], entry[1], entry[2]
    confidence = entry[3] if len(entry) > 3 else None
    return Observation(
        float(time), float(duration or 0.0), value, _float_or_none(confidence)
    )


def parse_jams(obj: dict) -> Jams:
    annotations = []
    for ann in obj.get("annotations", []):
        meta = ann.get("annotation_metadata", {}) or {}
        data = ann.get("data", [])
        if isinstance(data, dict):  # dense format: {"time": [...], ...}
            rows = zip(
                data.get("time", []),
                data.get("duration", []),
                data.get("value", []),
                data.get("confidence", []) or [None] * len(data.get("time", [])),
            )
            obs = tuple(
                Observation(float(t), float(d or 0.0), v, _float_or_none(c))
                for t, d, v, c in rows
            )
        else:
            obs = tuple(_parse_observation(e) for e in data)
        annotations.append(
            Annotation(
                namespace=ann.get("namespace", ""),
                data_source=(
                    str(meta["data_source"]) if "data_source" in meta else None
                ),
                observations=obs,
            )
        )
    duration = None
    fm = obj.get("file_metadata") or {}
    if fm.get("duration") is not None:
        duration = float(fm["duration"])
    return Jams(annotations=tuple(annotations), duration=duration)


def load_jams(path: str) -> Jams:
    with open(path) as f:
        return parse_jams(json.load(f))


def note_value_to_midi(value: Any) -> float | None:
    """note_midi observation value -> MIDI float (dict forms handled as in
    jam_to_tablature.py:127-139)."""
    if isinstance(value, dict):
        value = value.get("pitch", value.get("value"))
    try:
        return float(value)
    except (TypeError, ValueError):
        return None


def hz_to_midi(freq: float) -> float:
    """librosa.hz_to_midi: 12 * log2(f / 440) + 69."""
    import math

    return 12.0 * math.log2(freq / 440.0) + 69.0
