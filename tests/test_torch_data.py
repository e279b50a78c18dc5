"""The port's data side held to the JAX package on the same seeds and
NumPy inputs: synthetic tracks and their JAMS dicts (bit for bit), the
first-fit window labels, the seed-42 split, the loaders' batches, padding
weights and shuffle order, packed ``.npy`` trees, ``synthetic_loaders``
(labels equal; features within the CQT tolerance of
tests/test_cqt.py:214-224, 0.02 dB away from the gate), and
``validate_model`` over a loader with a short padded last batch.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guitar_tablature_classification_tpu.config import ModelConfig as JaxModelConfig
from guitar_tablature_classification_tpu.config import OptimConfig as JaxOptimConfig
from guitar_tablature_classification_tpu.data import guitarset as jax_guitarset
from guitar_tablature_classification_tpu.data import packing as jax_packing
from guitar_tablature_classification_tpu.data import synthetic as jax_synthetic
from guitar_tablature_classification_tpu.labels import jams_io as jax_jams_io
from guitar_tablature_classification_tpu.labels import tablature as jax_tablature
from guitar_tablature_classification_tpu.models import build_model as jax_build_model
from guitar_tablature_classification_tpu.train import create_train_state as jax_create_state
from guitar_tablature_classification_tpu.train import make_eval_step as jax_make_eval_step
from guitar_tablature_classification_tpu.train import make_preprocess as jax_make_preprocess
from guitar_tablature_classification_tpu.train import validate_model as jax_validate_model
from guitar_tablature_classification_tpu.train import run as jax_run
from guitar_tablature_classification_tpu_torch.config import ModelConfig, OptimConfig
from guitar_tablature_classification_tpu_torch.data import guitarset, packing, synthetic
from guitar_tablature_classification_tpu_torch.labels import jams_io, tablature
from guitar_tablature_classification_tpu_torch.models import build_model, state_dict_from_flax
from guitar_tablature_classification_tpu_torch.train import (
    create_train_state,
    make_eval_step,
    make_preprocess,
    validate_model,
)
from guitar_tablature_classification_tpu_torch.train import run


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads a test: the suite runs in six processes at once,
    and PyTorch's default of one spinning thread per core in each makes
    them fight for the cores (3.5x the wall time of these files)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("hardness", [0.0, 1.0])
@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_dataset_equal_bit_for_bit(seed, hardness):
    """Audio, events and JAMS dicts of make_synthetic_dataset, at the
    round-4 rendering and at the hardest robustness knobs."""
    def make(mod):
        render = mod.RenderConfig.hardness(hardness) if hardness else None
        return mod.make_synthetic_dataset(np.random.default_rng(seed), 3, duration=2.0,
                                          render=render)

    want, got = make(jax_synthetic), make(synthetic)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["audio"].dtype == w["audio"].dtype == np.float32
        assert np.array_equal(g["audio"], w["audio"])
        assert g["jams"] == w["jams"]
        assert g["events"] == w["events"] and g["name"] == w["name"]


@pytest.mark.parametrize("seed", [0, 7])
def test_first_fit_window_labels_equal(seed):
    """tablature_first_fit_window (and the per-string and lowest-fret
    readings) over every 0.2 s window of a synthetic track."""
    track = jax_synthetic.make_synthetic_dataset(np.random.default_rng(seed), 1)[0]
    jam, jjam = jams_io.parse_jams(track["jams"]), jax_jams_io.parse_jams(track["jams"])
    for i in range(20):
        start = 0.2 * i
        for name in ("tablature_first_fit_window", "tablature_per_string_window"):
            got = getattr(tablature, name)(jam, start, 0.2)
            want = getattr(jax_tablature, name)(jjam, start, 0.2)
            assert got.dtype == want.dtype and np.array_equal(got, want), (name, i)
        assert np.array_equal(tablature.tablature_lowest_fret_center(jam, start + 0.1),
                              jax_tablature.tablature_lowest_fret_center(jjam, start + 0.1))


@pytest.mark.parametrize("n, seed", [(10, 42), (157, 42), (1000, 3)])
def test_split_indices_equal(n, seed):
    for got, want in zip(guitarset.torch_random_split_indices(n, (0.8, 0.1, 0.1), seed),
                         jax_guitarset.torch_random_split_indices(n, (0.8, 0.1, 0.1), seed)):
        assert np.array_equal(got, want)


def _arrays(n=21, seed=0, one_hot=True):
    rng = np.random.default_rng(seed)
    feats = rng.uniform(-120, 0, (n, 96, 9)).astype(np.float32)
    frets = rng.integers(0, 19, (n, 6))
    labels = np.eye(19, dtype=np.int8)[frets] if one_hot else frets.astype(np.int32)
    return feats, labels


def _batches(loader, epochs=2):
    return [b for _ in range(epochs) for b in loader]


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys() == {"features", "labels", "weights"}
        for key in g:
            assert g[key].dtype == w[key].dtype and np.array_equal(g[key], w[key]), key


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("one_hot", [False, True])
def test_array_loader_batches_equal(shuffle, one_hot):
    """Batches, the zero padding of the short last batch with weights 0,
    and the shuffle order over two epochs."""
    feats, labels = _arrays(one_hot=one_hot)
    idx = np.arange(3, 21)  # 18 items, batch 8: 8, 8, 2 + 6 padded
    loaders = [mod.ArrayLoader(mod.ArrayDataset(feats, labels), idx, 8, shuffle=shuffle, seed=5)
               for mod in (guitarset, jax_guitarset)]
    got, want = _batches(loaders[0]), _batches(loaders[1])
    _assert_batches_equal(got, want)
    assert len(loaders[0]) == 3
    assert got[2]["weights"][:2].all() and not got[2]["weights"][2:].any()
    if shuffle:  # the two epochs differ in order
        assert not np.array_equal(got[0]["labels"], got[3]["labels"])
    item = guitarset.ArrayDataset(feats, labels)[4]
    want_item = jax_guitarset.ArrayDataset(feats, labels)[4]
    assert all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(item, want_item))


def _npy_tree(root, n=13):
    feats, labels = _arrays(n, seed=1)
    for d, arrays in (("features", feats), ("labels", labels)):
        os.makedirs(root / d)
        for i, a in enumerate(arrays):
            np.save(root / d / f"track_segment_{i:03d}.npy", a)
    return str(root / "features"), str(root / "labels")


def test_create_dataloaders_on_npy_tree(tmp_path):
    """create_dataloaders over a small .npy tree (packed on first use into
    each package's own cache): the three loaders' batches equal, and the
    packed shard equals the JAX package's."""
    fdir, ldir = _npy_tree(tmp_path)
    got = guitarset.create_dataloaders(fdir, ldir, 4, cache_dir=str(tmp_path / "port"))
    want = jax_guitarset.create_dataloaders(fdir, ldir, 4, cache_dir=str(tmp_path / "jax"))
    for g, w in zip(got, want):
        _assert_batches_equal(_batches(g), _batches(w))
    for part in ("features", "labels"):
        a, names = packing.load_packed(str(tmp_path / "port" / part))
        b, jnames = jax_packing.load_packed(str(tmp_path / "jax" / part))
        assert names == jnames and a.dtype == b.dtype and np.array_equal(a, b)
    # the default cache lies beside the labels directory
    guitarset.GuitarTabDataset(fdir, ldir)
    assert os.path.exists(tmp_path / "_packed" / "labels.npy")


def _cli_cfg(mod, argv):
    return mod.make_config(mod.build_parser().parse_args(argv))


def test_synthetic_loaders_match_jax(tmp_path):
    """Two tracks through both packages' synthetic_loaders (the CQT on the
    CPU: the port's plain version, the JAX package's XLA path): the same
    split, labels and padding weights; features within 0.02 dB away from
    the -60 dB gate, most of them equal to fp32 rounding."""
    argv = ["--synthetic", "--checkpoint-dir", str(tmp_path)]
    got = run.synthetic_loaders(_cli_cfg(run, argv), 2, device="cpu")
    want = jax_run.synthetic_loaders(_cli_cfg(jax_run, argv), 2)
    gate = -60.0
    for g_loader, w_loader in zip(got, want):
        assert g_loader.batch_size == w_loader.batch_size == 8
        assert np.array_equal(g_loader.indices, w_loader.indices)
        for g, w in zip(_batches(g_loader), _batches(w_loader)):
            assert np.array_equal(g["labels"], w["labels"])
            assert np.array_equal(g["weights"], w["weights"])
            boundary = np.abs(w["features"] - gate) < 0.5
            np.testing.assert_allclose(g["features"][~boundary], w["features"][~boundary],
                                       atol=0.02)
            assert g["features"].dtype == np.float32


def test_validate_model_matches_jax_with_padded_batch():
    """validate_model on resnet18_native at fp32 from the same weights,
    over 13 items in batches of 8 (the last padded with weights 0): equal
    correct/count per string, the exact weighted loss to rtol 1e-5."""
    jcfg = JaxModelConfig(arch="resnet18_native", dtype="float32")
    cfg = ModelConfig(arch="resnet18_native", dtype="float32")
    feats, labels = _arrays(13, seed=2, one_hot=False)
    jmodel, jpre = jax_build_model(jcfg), jax_make_preprocess(jcfg)
    jstate = jax_create_state(jmodel, JaxOptimConfig(), jax.random.PRNGKey(0),
                              jpre(jnp.asarray(feats[:1])))
    model = build_model(cfg)
    model.load_state_dict(state_dict_from_flax(jax.tree.map(
        np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats})), strict=True)
    state = create_train_state(model, OptimConfig(), device="cpu")

    def loader(mod):
        return mod.ArrayLoader(mod.ArrayDataset(feats, labels), np.arange(13), 8)

    want = jax_validate_model(jstate, jax_make_eval_step(jmodel, jpre), loader(jax_guitarset))
    got = validate_model(state, make_eval_step(model, make_preprocess(cfg)), loader(guitarset))
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert np.array_equal(got["per_string_accuracy"], want["per_string_accuracy"])
    assert got["accuracy"] == want["accuracy"]
    # 13 real rows: the padded ones count nowhere
    assert np.all(got["per_string_accuracy"] * 13 == np.round(got["per_string_accuracy"] * 13))


def test_render_config_and_helpers_equal():
    assert dataclasses.asdict(synthetic.RenderConfig.hardness(0.5)) == \
        dataclasses.asdict(jax_synthetic.RenderConfig.hardness(0.5))
    assert synthetic.midi_to_hz(57.3) == jax_synthetic.midi_to_hz(57.3)
    rng, jrng = np.random.default_rng(4), np.random.default_rng(4)
    assert synthetic.random_performance(rng, 3.0, style="sparse") == \
        jax_synthetic.random_performance(jrng, 3.0, style="sparse")
    frets = np.random.default_rng(0).integers(0, 19, (5, 6))
    tab = np.eye(19, dtype=np.int8)[frets]
    assert np.array_equal(tablature.tablature_to_frets(tab), jax_tablature.tablature_to_frets(tab))


def test_port_loader_batches_move_to_the_state_device():
    """batch_to_device: CPU arrays stay on the CPU here (the card path
    copies through pinned memory, tests/test_torch_cuda.py)."""
    from guitar_tablature_classification_tpu_torch.train import batch_to_device

    feats, labels = _arrays(4, one_hot=False)
    out = batch_to_device({"features": feats, "labels": labels}, torch.device("cpu"))
    assert out["features"].dtype == torch.float32 and out["labels"].dtype == torch.int32
    assert np.array_equal(out["features"].numpy(), feats)
