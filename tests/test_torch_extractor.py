"""The port's label extractor (``labels/extractor.py``, ``tab-extract-labels``)
held to the JAX package's on the same JAMS files: the same label files,
byte for byte and by name, the same repair, validation and fixture-diff
results, and the same CLI exit codes and output (after
tests/test_labels.py:441-533)."""

import json
import os

import numpy as np
import pytest

from guitar_tablature_classification_tpu.data.synthetic import (
    events_to_jams_dict,
    random_performance,
)
from guitar_tablature_classification_tpu.labels import extractor as jax_extractor
from guitar_tablature_classification_tpu_torch.labels import extractor

CONVENTIONS = ["first_fit_window", "per_string_window", "lowest_fret_center"]


def _note(time, duration, value):
    return {"time": time, "duration": duration, "value": value, "confidence": None}


def _jams_dict(per_string_notes, duration):
    return {
        "file_metadata": {"duration": duration},
        "annotations": [
            {"namespace": "note_midi", "annotation_metadata": {"data_source": str(s)},
             "data": [_note(*n) for n in notes]}
            for s, notes in enumerate(per_string_notes)
        ],
    }


@pytest.fixture(scope="module")
def jams_dir(tmp_path_factory):
    """Three seeded synthetic performances, one with silent gaps (all-zero
    segments under lowest_fret_center), and one file that fails to parse."""
    d = tmp_path_factory.mktemp("jams")
    rng = np.random.default_rng(0)
    for i, seconds in enumerate((2.0, 1.4, 3.0)):
        events = random_performance(rng, seconds)
        (d / f"{i:02d}_track_{'comp' if i % 2 else 'solo'}.jams").write_text(
            json.dumps(events_to_jams_dict(events, seconds)))
    gaps = _jams_dict([[(0.0, 0.25, 45.0), (0.8, 0.4, 45.0)], [], [(0.1, 0.3, 52.0)],
                       [], [], []], 1.2)
    (d / "03_gaps.jams").write_text(json.dumps(gaps))
    (d / "04_broken.jams").write_text("{not json")
    return d


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("convention", CONVENTIONS)
def test_process_all_files_writes_the_same_bytes(jams_dir, tmp_path, convention):
    got_dir, want_dir = tmp_path / "port", tmp_path / "jax"
    got = extractor.GuitarTablatureExtractor(str(jams_dir), str(got_dir),
                                             convention=convention).process_all_files()
    want = jax_extractor.GuitarTablatureExtractor(str(jams_dir), str(want_dir),
                                                  convention=convention).process_all_files()
    assert vars(got) == vars(want)
    assert got.errors and got.processed_files == 4
    files = _files(got_dir)
    assert files == _files(want_dir) and len(files) == got.total_segments

    # repair (which rewrites files in place) and validation agree too
    assert extractor.fix_tablature_data(str(got_dir)) == \
        jax_extractor.fix_tablature_data(str(want_dir))
    assert _files(got_dir) == _files(want_dir)
    ex = extractor.GuitarTablatureExtractor(str(jams_dir), str(got_dir), convention=convention)
    jex = jax_extractor.GuitarTablatureExtractor(str(jams_dir), str(want_dir),
                                                 convention=convention)
    assert ex.validate_tablature_data(sample_size=7, seed=3) == \
        jex.validate_tablature_data(sample_size=7, seed=3)
    assert ex.fix_tablature_data() == jex.fix_tablature_data()


def test_diff_against_matches_jax(jams_dir, tmp_path):
    """A fixtures directory with one changed file, one missing and one
    extra: the same report from both packages, and a clean one is
    bit-for-bit."""
    fixtures = tmp_path / "fixtures"
    extractor.GuitarTablatureExtractor(str(jams_dir), str(fixtures)).process_all_files()
    ex = extractor.GuitarTablatureExtractor(str(jams_dir), str(tmp_path / "out"))
    jex = jax_extractor.GuitarTablatureExtractor(str(jams_dir), str(tmp_path / "out"))
    clean = ex.diff_against(str(fixtures))
    assert clean == jex.diff_against(str(fixtures))
    assert clean["segments"] > 0 and clean["errors"]  # the broken file
    names = sorted(os.listdir(fixtures))
    tab = np.load(fixtures / names[0])
    np.save(fixtures / names[0], np.roll(tab, 1, axis=-1))
    os.remove(fixtures / names[1])
    np.save(fixtures / "zz_extra_segment_9_0.00.npy", tab)
    report = ex.diff_against(str(fixtures), max_detail=5)
    assert report == jex.diff_against(str(fixtures), max_detail=5)
    assert (report["mismatched"], report["missing_fixture"], report["extra_fixtures"]) == \
        (1, 1, 1) and not report["bit_for_bit"]


def test_find_audio_and_neighbor_names_match_jax(tmp_path):
    for name in ("00_track_comp_mic.wav", "hex_debleeded_01_x.wav"):
        (tmp_path / name).write_bytes(b"")
    for base in ("00_track_comp", "01_x", "missing"):
        assert extractor.find_audio_for_jams(str(tmp_path), base) == \
            jax_extractor.find_audio_for_jams(str(tmp_path), base)
    for fname in ("trk_0003.npy", "a_b_segment_7_0.40.npy", "bad.npy", "x_segment_1_z.npy"):
        assert extractor._neighbor_names(fname, 0.2) == \
            jax_extractor._neighbor_names(fname, 0.2)


@pytest.mark.parametrize("argv", [
    ["--validate"],
    ["--repair", "--convention", "lowest_fret_center"],
    ["--convention", "per_string_window", "--window", "0.4"],
], ids=["validate", "repair_center", "per_string_0.4"])
def test_cli_matches_jax(jams_dir, tmp_path, capsys, argv):
    rc = extractor.main([str(jams_dir), str(tmp_path / "port"), *argv])
    got = capsys.readouterr().out
    want_rc = jax_extractor.main([str(jams_dir), str(tmp_path / "jax"), *argv])
    want = capsys.readouterr().out
    assert rc == want_rc == 0
    assert got == want and "errors=1" in got
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


def test_cli_diff_exit_codes_match_jax(jams_dir, tmp_path, capsys):
    fixtures = tmp_path / "fixtures"
    extractor.main([str(jams_dir), str(fixtures)])
    capsys.readouterr()
    argv = [str(jams_dir), str(tmp_path / "unused"), "--diff", str(fixtures)]
    # the broken file is an error: not bit-for-bit, exit 1 on both sides
    assert extractor.main(argv) == jax_extractor.main(argv) == 1
    out = capsys.readouterr().out.splitlines()
    assert out[: len(out) // 2] == out[len(out) // 2:]
    assert "bit_for_bit=False" in out[0]
