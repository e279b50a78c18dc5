"""The port's native host data path (``data/native_loader.py``, the
``ctypes`` binding of ``native/tabhost.cc`` built into the port's
``_build/``) and the raw-audio loader (``data/audio_loader.py``), held to
the JAX package's on the same WAV files and seeds: the same arrays and the
same batch order, bit for bit, on the native path and on the NumPy one
(both bindings over one library built from ``native/tabhost.cc``)."""

import os
import subprocess
import sys

import numpy as np
import pytest
from scipy.io import wavfile

from guitar_tablature_classification_tpu.config import CQTConfig as JaxCQTConfig
from guitar_tablature_classification_tpu.data import audio_loader as jax_audio_loader
from guitar_tablature_classification_tpu.data import native_loader as jax_native
from guitar_tablature_classification_tpu_torch.config import CQTConfig
from guitar_tablature_classification_tpu_torch.data import audio_loader, native_loader

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_library(monkeypatch):
    """The JAX binding loads the library the port built from the same
    source, so both packages' Python sides drive one library, and this file
    never runs ``make -C native`` (tests/test_native.py may be building
    there in another process)."""
    assert native_loader.ensure_built()
    monkeypatch.setattr(jax_native, "_LIB_PATH", native_loader.library_path())
    monkeypatch.setattr(jax_native, "_lib", None)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Three int16 tracks of 1.0, 0.6 and 0.45 s, and fixture-named labels
    on the 0.2 s grid for all but one window of the first two."""
    d = tmp_path_factory.mktemp("tree")
    (d / "audio").mkdir()
    (d / "labels").mkdir()
    rng = np.random.default_rng(0)
    tracks = []
    for rank, (base, seconds) in enumerate((("b_comp", 1.0), ("a_solo", 0.6), ("c_comp", 0.45))):
        x = np.clip(0.25 * rng.standard_normal(int(44100 * seconds)), -0.95, 0.95)
        path = str(d / "audio" / f"{base}.wav")
        wavfile.write(path, 44100, (x * 32767).astype(np.int16))
        tracks.append((path, base))
        if base == "c_comp":
            continue
        for k in range(int(seconds / 0.2 + 1e-9) - (base == "b_comp")):
            tab = np.eye(19, dtype=np.int8)[rng.integers(0, 19, 6)]
            np.save(d / "labels" / f"{base}_segment_{rank}_{0.2 * k:.2f}.npy", tab)
    return d, tracks


def test_wav_read_and_frame_windows_match_jax(tree):
    _, tracks = tree
    audio, sr = native_loader.wav_read(tracks[0][0])
    want, want_sr = jax_native.wav_read(tracks[0][0])
    assert sr == want_sr == 44100 and np.array_equal(audio, want)
    for window, hop in ((8820, 8820), (4410, 2205), (50000, 10)):
        got = native_loader.frame_windows(audio, window, hop)
        assert np.array_equal(got, jax_native.frame_windows(audio, window, hop))
    assert native_loader.frame_windows(audio, 4410, 2205).shape == (19, 4410)


def test_native_window_loader_matches_jax(tree):
    """The same batches in the same order for a seed, across an epoch's
    wrap and reshuffle."""
    paths = [p for p, _ in tree[1]]
    kw = dict(window_samples=4410, hop_samples=2205, batch_size=8, seed=3, num_threads=2)
    got, want = native_loader.NativeWindowLoader(paths, **kw), jax_native.NativeWindowLoader(paths, **kw)
    assert len(got) == len(want) == 19 + 11 + 8
    for _ in range(len(got) // 8 + 3):
        for a, b in zip(got.next_batch(), want.next_batch()):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    got.close()
    want.close()
    got.close()  # idempotent


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_audio_window_loader_matches_jax(tree, monkeypatch, native):
    d, tracks = tree
    if not native:
        monkeypatch.setattr(native_loader, "ensure_built", lambda: False)
        monkeypatch.setattr(jax_native, "ensure_built", lambda **kw: False)
    got = audio_loader.AudioWindowLoader(tracks, str(d / "labels"), 4, CQTConfig(), seed=5)
    want = jax_audio_loader.AudioWindowLoader(tracks, str(d / "labels"), 4, JaxCQTConfig(),
                                              seed=5)
    assert got.native is native
    assert len(got) == len(want) == 5 + 3 + 2
    weights = []
    for g, w in zip(got.batches(6), want.batches(6)):
        assert set(g) == set(w) == {"audio", "labels", "weights"}
        for key in g:
            assert g[key].dtype == w[key].dtype and np.array_equal(g[key], w[key]), key
        weights.append(g["weights"])
    weights = np.concatenate(weights)
    assert 0 < weights.mean() < 1  # unlabelled windows carry weight 0


def test_label_grid_and_discover_tracks_match_jax(tree):
    d, _ = tree
    for base in ("b_comp", "a_solo", "c_comp"):
        got = audio_loader.load_label_grid(str(d / "labels"), base)
        want = jax_audio_loader.load_label_grid(str(d / "labels"), base)
        assert got.keys() == want.keys()
        assert all(np.array_equal(got[k], want[k]) for k in got)
    assert audio_loader.discover_tracks(str(d / "audio")) == \
        jax_audio_loader.discover_tracks(str(d / "audio"))


_BUILD = """
import sys
sys.path.insert(0, {root!r})
from guitar_tablature_classification_tpu_torch.data import native_loader
native_loader.BUILD_DIR = {build!r}
assert native_loader.ensure_built()
print(native_loader.wav_read({wav!r})[1])
"""


def test_parallel_builds_both_succeed(tree, tmp_path):
    """Two processes building the library into one empty directory at once
    both end with one loadable library, in the build directory."""
    wav = tree[1][0][0]
    script = _BUILD.format(root=ROOT, build=str(tmp_path / "_build"), wav=wav)
    procs = [subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    assert [o.strip() for o, _ in outs] == ["44100", "44100"]
    assert [n for n in os.listdir(tmp_path / "_build") if n.endswith(".so")] == \
        [os.path.basename(native_loader.library_path())]


def test_build_failure_raises_and_missing_compiler_returns_false(tmp_path, monkeypatch):
    bad = tmp_path / "tabhost.cc"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native_loader, "SOURCE", str(bad))
    monkeypatch.setattr(native_loader, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on tabhost.cc"):
        native_loader.ensure_built()
    monkeypatch.setattr(native_loader.shutil, "which", lambda name: None)
    assert native_loader.ensure_built() is False
    monkeypatch.setattr(native_loader, "SOURCE", str(tmp_path / "missing.cc"))
    assert native_loader.ensure_built() is False
