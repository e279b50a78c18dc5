"""The port's GuitarSet runbook (``tools/run_guitarset.py``, with
``tools/make_synthetic_guitarset.py``) on the CPU, after
tests/test_runbook.py:49-113: WAV + JAMS directories in, fixture-named
features, regenerated labels, the pairing audit, training (``small_cnn``,
``--device cpu``) and the baseline table out.  The features and labels it
writes are held to the JAX package's extraction and extractor on the same
tree."""

import json
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from guitar_tablature_classification_tpu.config import CQTConfig as JaxCQTConfig
from guitar_tablature_classification_tpu.data.synthetic import (
    events_to_jams_dict,
    make_synthetic_dataset,
)
from guitar_tablature_classification_tpu.labels import GuitarTablatureExtractor as JaxExtractor
from guitar_tablature_classification_tpu.ops.extract import process_all_audio as jax_process
from guitar_tablature_classification_tpu_torch.infer import cli
from guitar_tablature_classification_tpu_torch.tools import (
    make_synthetic_guitarset,
    run_guitarset,
)


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _write_tree(tmp_path, num_tracks=3, duration=2.0):
    """The JAX runbook test's tree: seeded synthetic tracks, GuitarSet's
    ``_hex.wav`` suffix."""
    cfg = JaxCQTConfig()
    audio_dir, jams_dir = tmp_path / "audio", tmp_path / "annotation"
    audio_dir.mkdir()
    jams_dir.mkdir()
    for track in make_synthetic_dataset(np.random.default_rng(0), num_tracks, duration=duration,
                                        cfg=cfg):
        wavfile.write(audio_dir / f"{track['name']}_hex.wav", cfg.sample_rate,
                      (np.clip(track["audio"], -1, 1) * 32767).astype(np.int16))
        (jams_dir / f"{track['name']}.jams").write_text(
            json.dumps(events_to_jams_dict(track["events"], duration)))
    return audio_dir, jams_dir


def test_runbook_end_to_end(tmp_path, capsys):
    audio_dir, jams_dir = _write_tree(tmp_path)
    work = tmp_path / "work"
    rc = run_guitarset.main([
        "--audio", str(audio_dir), "--annotation", str(jams_dir), "--workdir", str(work),
        "--arch", "small_cnn", "--epochs", "2", "--batch-size", "8",
        "--learning-rate", "0.003", "--device", "cpu", "--report-dir", str(tmp_path / "report"),
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "[2/4] wrote 30 CQT feature files in" in out and "windows/s" in out
    assert "[3/4] generated" in out
    assert "pairing audit:" in out and "exact match" in out
    assert "msg=epoch 2/2" in out and "[4/4] trained in" in out
    assert "reference" in out and "    mean |" in out
    for s in range(1, 7):
        assert f"       {s} |" in out
    feats = sorted(os.listdir(work / "features"))
    labels = sorted(os.listdir(work / "labels"))
    assert feats == labels and len(feats) == 30
    assert "synth00_comp_segment_0_0.20.npy" in feats
    assert (work / "checkpoints" / "best_guitar_tab_model.pt").exists()
    assert len(os.listdir(tmp_path / "report")) == 7
    # the serving CLI transcribes with the trained small_cnn
    wav = str(next(audio_dir.iterdir()))
    tab = str(tmp_path / "tab.txt")
    assert cli.main([wav, "--arch", "small_cnn", "--model",
                     str(work / "checkpoints" / "best_guitar_tab_model"), "--device", "cpu",
                     "--output", tab]) == 0
    assert sum(ln[:2] in ("e|", "E|") for ln in open(tab)) == 2
    capsys.readouterr()

    # the labels are the JAX extractor's, byte for byte
    JaxExtractor(str(jams_dir), str(tmp_path / "jax_labels")).process_all_files()
    for name in labels:
        assert (work / "labels" / name).read_bytes() == \
            (tmp_path / "jax_labels" / name).read_bytes()
    # the features are the JAX extraction's (fixture naming on the 0.2 s
    # grid; the runbook names by JAMS base, the extraction by WAV base)
    written = jax_process(str(audio_dir), 0.2, 0.2, str(tmp_path / "jax_feats"),
                          fixture_naming=True)
    assert len(written) == len(feats)
    for path in written:
        want = np.load(path)
        got = np.load(work / "features" / os.path.basename(path).replace("_hex_segment",
                                                                           "_segment"))
        boundary = np.abs(want - JaxCQTConfig().gate_threshold_db) < 0.5
        np.testing.assert_allclose(got[~boundary], want[~boundary], atol=0.02)


def test_runbook_with_shipped_fixtures_and_reuse(tmp_path, capsys):
    """--fixtures trains against a tablatures/ directory; a second run
    reuses the features already in --workdir."""
    from guitar_tablature_classification_tpu_torch.labels import GuitarTablatureExtractor

    audio_dir, jams_dir = _write_tree(tmp_path, num_tracks=2, duration=1.2)
    fixtures = tmp_path / "tablatures"
    GuitarTablatureExtractor(str(jams_dir), str(fixtures)).process_all_files()
    argv = ["--audio", str(audio_dir), "--annotation", str(jams_dir),
            "--workdir", str(tmp_path / "work"), "--fixtures", str(fixtures),
            "--arch", "small_cnn", "--epochs", "1", "--batch-size", "8", "--device", "cpu"]
    assert run_guitarset.main(argv) == 0
    out = capsys.readouterr().out
    assert "using shipped label fixtures" in out and "exact match" in out
    assert not (tmp_path / "work" / "labels").exists()
    assert run_guitarset.main(argv) == 0
    assert "features exist" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="recipe implies an arch"):
        run_guitarset.main([*argv, "--recipe", "native-best"])


def test_runbook_pairing_audit_intersection(tmp_path, capsys):
    fdir, ldir = tmp_path / "f", tmp_path / "l"
    fdir.mkdir()
    ldir.mkdir()
    common = ["a_segment_0_0.00.npy", "a_segment_0_0.20.npy"]
    for name in common + ["only_feat.npy"]:
        np.save(fdir / name, np.zeros((96, 9), np.float32))
    for name in common + ["only_label.npy"]:
        np.save(ldir / name, np.zeros((6, 19), np.int8))
    f2, l2 = run_guitarset.audit_pairing(str(fdir), str(ldir), str(tmp_path))
    assert "2 paired, 1 feature-only, 1 label-only" in capsys.readouterr().out
    assert sorted(os.listdir(f2)) == sorted(os.listdir(l2)) == common


def test_make_synthetic_guitarset_tree(tmp_path, capsys):
    assert make_synthetic_guitarset.main(["--out", str(tmp_path), "--excerpts", "3",
                                          "--duration", "0.6", "--seed", "1"]) == 0
    assert sorted(os.listdir(tmp_path / "audio")) == [
        "00_Synth000_comp_hex.wav", "00_Synth000_solo_hex.wav", "01_Synth001_comp_hex.wav"]
    jam = json.loads((tmp_path / "annotation" / "00_Synth000_solo.jams").read_text())
    assert len(jam["annotations"]) == 6
    sr, audio = wavfile.read(tmp_path / "audio" / "00_Synth000_comp_hex.wav")
    assert sr == 44100 and audio.dtype == np.int16 and audio.shape == (26460,)
    assert "wrote 3 excerpts" in capsys.readouterr().out
