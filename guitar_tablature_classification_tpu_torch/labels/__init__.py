"""JAMS reading, tablature labels and the batch label extractor (copies of
the JAX package's ``labels/jams_io.py``, ``labels/tablature.py`` and
``labels/extractor.py``)."""

from .extractor import (
    ExtractionStats,
    GuitarTablatureExtractor,
    find_audio_for_jams,
    fix_tablature_data,
)
from .jams_io import (
    Annotation,
    Jams,
    Observation,
    hz_to_midi,
    load_jams,
    note_value_to_midi,
    parse_jams,
)
from .tablature import (
    empty_tablature,
    midi_to_tablature_first_fit,
    midi_to_tablature_lowest_fret,
    tablature_first_fit_window,
    tablature_from_pitch_contour,
    tablature_lowest_fret_center,
    tablature_per_string_window,
    tablature_to_frets,
)

__all__ = [
    "Annotation", "ExtractionStats", "GuitarTablatureExtractor", "find_audio_for_jams",
    "fix_tablature_data", "Jams", "Observation", "empty_tablature", "hz_to_midi",
    "load_jams", "midi_to_tablature_first_fit", "midi_to_tablature_lowest_fret",
    "note_value_to_midi", "parse_jams", "tablature_first_fit_window",
    "tablature_from_pitch_contour", "tablature_lowest_fret_center",
    "tablature_per_string_window", "tablature_to_frets",
]
