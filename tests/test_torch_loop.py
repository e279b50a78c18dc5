"""The port's training loop held to the JAX package: schedules, metrics,
``train_model`` (history at rtol 1e-5 against the JAX ``train_model`` from
the same weights), the best-epoch copy, resume, checkpoints and their
named errors.

``train_model`` runs ``resnet18_native`` at fp32 with its heads' dropout at
0 on both sides, two shuffled batches of 8 and two epochs, at lr 1e-5:
tests/test_torch_train.py holds three train steps at that rate to the JAX
ones at rtol 1e-5 (at larger rates the trajectory itself is chaotic).
"""

import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from guitar_tablature_classification_tpu.config import ModelConfig as JaxModelConfig
from guitar_tablature_classification_tpu.config import OptimConfig as JaxOptimConfig
from guitar_tablature_classification_tpu.config import TrainConfig as JaxTrainConfig
from guitar_tablature_classification_tpu.data import guitarset as jax_guitarset
from guitar_tablature_classification_tpu.models.heads import StringBranchHeads as JaxHeads
from guitar_tablature_classification_tpu.models.resnet import ResNet18 as JaxResNet18
from guitar_tablature_classification_tpu.train import confusion_matrices as jax_confusion
from guitar_tablature_classification_tpu.train import create_train_state as jax_create_state
from guitar_tablature_classification_tpu.train import make_preprocess as jax_make_preprocess
from guitar_tablature_classification_tpu.train import metrics as jax_metrics
from guitar_tablature_classification_tpu.train import schedules as jax_schedules
from guitar_tablature_classification_tpu.train import train_model as jax_train_model
from guitar_tablature_classification_tpu_torch.config import (
    ModelConfig,
    OptimConfig,
    TrainConfig,
)
from guitar_tablature_classification_tpu_torch.data import guitarset
from guitar_tablature_classification_tpu_torch.models import (
    build_model,
    load_torch_checkpoint,
    state_dict_from_flax,
)
from guitar_tablature_classification_tpu_torch.models.heads import Dropout
from guitar_tablature_classification_tpu_torch.train import (
    Checkpointer,
    CheckpointMismatchError,
    OrbaxCheckpointError,
    create_train_state,
    find_checkpoint,
    make_eval_step,
    make_preprocess,
    metrics,
    schedules,
    train_model,
    validate_model,
)
from guitar_tablature_classification_tpu_torch.utils import prng

NATIVE = ModelConfig(arch="resnet18_native", dtype="float32")


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads a test: the suite runs in six processes at once,
    and PyTorch's default of one spinning thread per core in each makes
    them fight for the cores (3.5x the wall time of these files)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

# ------------------------------------------------------------- schedules

VAL_LOSSES = [2.0, 1.9, 1.9, 1.95, 1.91, 1.9, 1.89, 2.5, 2.5, 2.5, 2.5, 1.0, 1.0001,
              0.99995, 1.2, 1.2, 1.2, 1.2, 1.2, 1.2]


@pytest.mark.parametrize("cfg_kw", [
    {},
    {"plateau_factor": 0.3, "plateau_patience": 1},
    {"schedule": "cosine_warm_restarts"},
    {"schedule": "cosine_warm_restarts", "cosine_t0": 3, "cosine_t_mult": 1,
     "cosine_eta_min": 1e-5, "learning_rate": 2e-3},
    {"schedule": "constant"},
])
def test_schedules_give_equal_learning_rates(cfg_kw):
    """make_scheduler's lr sequence over the same val losses, as the loop
    steps it (epoch, val loss, lr)."""
    got_s = schedules.make_scheduler(OptimConfig(**cfg_kw))
    want_s = jax_schedules.make_scheduler(JaxOptimConfig(**cfg_kw))
    lr = want = OptimConfig(**cfg_kw).learning_rate
    for epoch, loss in enumerate(VAL_LOSSES):
        lr, want = got_s(epoch, loss, lr), want_s(epoch, loss, want)
        assert lr == want, epoch
    if cfg_kw.get("schedule") is None:
        assert lr < OptimConfig(**cfg_kw).learning_rate  # the plateau cut it


def test_schedule_classes_and_unknown_name():
    p, jp = schedules.ReduceLROnPlateau(patience=0), jax_schedules.ReduceLROnPlateau(patience=0)
    assert [p.step(x, 1.0) for x in (1, 2, 3)] == [jp.step(x, 1.0) for x in (1, 2, 3)]
    c = schedules.CosineAnnealingWarmRestarts(base_lr=1e-3)
    jc = jax_schedules.CosineAnnealingWarmRestarts(base_lr=1e-3)
    assert [c.lr_at(e) for e in range(40)] == [jc.lr_at(e) for e in range(40)]
    with pytest.raises(ValueError, match="unknown schedule"):
        schedules.make_scheduler(OptimConfig(schedule="linear"))


# --------------------------------------------------------------- metrics


def test_confusion_matrices_and_per_fret_accuracy_match_jax():
    rng = np.random.default_rng(0)
    preds, targets = rng.integers(0, 19, (300, 6)), rng.integers(0, 19, (300, 6))
    targets[:40] = preds[:40]
    want = np.asarray(jax_confusion(jnp.asarray(preds), jnp.asarray(targets)))
    got = metrics.confusion_matrices(torch.from_numpy(preds), torch.from_numpy(targets))
    assert got.shape == (6, 19, 19) and np.array_equal(got.numpy(), want)
    for g, w in zip(metrics.per_fret_accuracy(want), jax_metrics.per_fret_accuracy(want)):
        assert np.array_equal(g, w)
    assert np.array_equal(metrics.row_normalize(want), jax_metrics.row_normalize(want))


# ------------------------------------------------------------ train_model


def _data(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-120, 0, (n, 96, 9)).astype(np.float32),
            rng.integers(0, 19, (n, 6)).astype(np.int32))


def _loaders(mod, train, val, batch=8):
    tr = mod.ArrayLoader(mod.ArrayDataset(*train), np.arange(len(train[0])), batch,
                         shuffle=True, seed=3)
    va = mod.ArrayLoader(mod.ArrayDataset(*val), np.arange(len(val[0])), batch)
    return tr, va


class _NoDropoutTabNet(fnn.Module):
    """The JAX GuitarTabNet for resnet18_native with its heads' dropout at
    0, under the same variable names (as in tests/test_torch_train.py)."""

    @fnn.compact
    def __call__(self, x, train: bool = False):
        feats = JaxResNet18(num_features=256, input_channels=1, dtype=jnp.float32,
                            name="resnet")(x, train=train)
        return JaxHeads(dropout=(0.0, 0.0), name="heads")(feats, train=train)


def _port_state(variables, optim=None):
    model = build_model(NATIVE)
    model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, variables)),
                          strict=True)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0  # as _NoDropoutTabNet on the JAX side
    return create_train_state(model, optim or OptimConfig(), device="cpu")


def test_train_model_history_matches_jax():
    """History of two epochs (train loss, val loss, lr) at rtol 1e-5, the
    same keys, and the returned (best) state's step."""
    train, val = _data(16, 0), _data(12, 1)
    optim = OptimConfig(learning_rate=1e-5, epochs=2)
    cfg = TrainConfig(model=NATIVE, optim=optim)
    jcfg = JaxTrainConfig(model=JaxModelConfig(arch="resnet18_native", dtype="float32"),
                          optim=JaxOptimConfig(learning_rate=1e-5, epochs=2))
    jmodel = _NoDropoutTabNet()
    jstate = jax_create_state(jmodel, jcfg.optim, jax.random.PRNGKey(0),
                              jax_make_preprocess(jcfg.model)(jnp.asarray(train[0][:1])))
    state = _port_state({"params": jstate.params, "batch_stats": jstate.batch_stats}, optim)
    logs = []
    jstate, want = jax_train_model(*_loaders(jax_guitarset, train, val), jcfg, model=jmodel,
                                   state=jstate, log=lambda s: None)
    state, got = train_model(*_loaders(guitarset, train, val), cfg, state=state, log=logs.append)
    assert set(got) == set(want)
    for key in ("train_loss", "val_loss", "lr"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(got["val_per_string"], want["val_per_string"], atol=1e-6)
    np.testing.assert_allclose(got["best_val_loss"], want["best_val_loss"], rtol=1e-5)
    # both return the best epoch's state (two steps an epoch)
    assert state.step == int(jstate.step) == 2 * (1 + int(np.argmin(want["val_loss"])))
    assert len(got["segments_per_sec"]) == 2 and logs[0].startswith("epoch 1/2: train ")


def _recorder():
    seen = []

    def on_epoch_end(epoch, history, state):
        seen.append({"epoch": epoch, "step": state.step, "params": state.params.clone(),
                     "buffers": state.buffers.clone(), "mu": state.opt_state.mu.clone(),
                     "count": int(state.opt_state.count)})

    return seen, on_epoch_end


def test_returned_state_is_the_best_epoch(tmp_path):
    """Train toward fret 18 on every string at lr 5e-3, validate on fret 0:
    the val loss rises after epoch 1 (2.7 -> 44 -> 281 here), so the
    returned state (changed in place by later steps) must be epoch 1's
    again, and so must the checkpoint."""
    feats, _ = _data(16, 2)
    train = (feats, np.full((16, 6), 18, np.int32))
    val = (_data(8, 3)[0], np.zeros((8, 6), np.int32))
    cfg = TrainConfig(model=NATIVE, optim=OptimConfig(learning_rate=5e-3, epochs=3,
                                                      early_stop_patience=5))
    seen, on_epoch_end = _recorder()
    ckpt = Checkpointer(str(tmp_path), "best")
    state, history = train_model(*_loaders(guitarset, train, val), cfg, device="cpu",
                                 on_epoch_end=on_epoch_end, checkpointer=ckpt,
                                 log=lambda s: None)
    v = history["val_loss"]
    assert v[1] > v[0] and v[2] > v[0], v
    assert history["best_val_loss"] == v[0]
    first = seen[0]
    assert state.step == first["step"] == 2 and seen[-1]["step"] == 6
    assert torch.equal(state.params, first["params"])
    assert torch.equal(state.buffers, first["buffers"])
    assert torch.equal(state.opt_state.mu, first["mu"])
    assert int(state.opt_state.count) == first["count"] == 2
    assert not torch.equal(seen[-1]["params"], first["params"])
    # the model's parameters are views of the restored buffer
    p0 = next(state.model.parameters())
    assert p0.data_ptr() == state.params.data_ptr()
    eval_step = make_eval_step(state.model, make_preprocess(NATIVE))
    again = validate_model(state, eval_step, _loaders(guitarset, train, val)[1])
    assert again["loss"] == v[0]
    assert ckpt.load_meta()["epoch"] == 0 and ckpt.load_meta()["step"] == 2


def test_resume_continues_as_the_uninterrupted_run(tmp_path):
    """Two epochs in one run against one epoch, a checkpoint, and a resumed
    second epoch from a fresh state: dropout is on (its masks come from the
    step's generator, seeded from (seed, step)), the loaders unshuffled.
    The second epoch's history and the final state agree."""
    train, val = _data(16, 4), _data(8, 5)
    cfg = TrainConfig(model=dataclasses.replace(NATIVE),
                      optim=OptimConfig(learning_rate=1e-4, epochs=2))

    def loaders():
        return (guitarset.ArrayLoader(guitarset.ArrayDataset(*train), np.arange(16), 8),
                guitarset.ArrayLoader(guitarset.ArrayDataset(*val), np.arange(8), 8))

    full_seen, full_cb = _recorder()
    _, full = train_model(*loaders(), cfg, device="cpu", on_epoch_end=full_cb,
                          log=lambda s: None)
    ckpt = Checkpointer(str(tmp_path / "ck"))
    one = dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim, epochs=1))
    train_model(*loaders(), one, device="cpu", checkpointer=ckpt, log=lambda s: None)
    logs = []
    seen, cb = _recorder()
    state, resumed = train_model(*loaders(), cfg, device="cpu", checkpointer=ckpt,
                                 resume=True, on_epoch_end=cb, log=logs.append)
    assert logs[0] == "resumed from epoch 1 (step 2)"
    assert len(resumed["train_loss"]) == 1 and logs[1].startswith("epoch 2/2")
    np.testing.assert_allclose(resumed["train_loss"][0], full["train_loss"][1], rtol=1e-6)
    np.testing.assert_allclose(resumed["val_loss"][0], full["val_loss"][1], rtol=1e-6)
    np.testing.assert_allclose(seen[0]["params"].numpy(), full_seen[1]["params"].numpy(),
                               rtol=1e-6, atol=1e-7)
    assert seen[0]["step"] == full_seen[1]["step"] == 4


def test_checkpoint_round_trip(tmp_path):
    """save -> restore into a fresh state: parameters, running averages,
    moments, count and step; the meta file; the .pt file is a reference
    checkpoint (load_torch_checkpoint); find_checkpoint's two forms, and
    None (no directory made) for what is no checkpoint."""
    train, val = _data(8, 6), _data(8, 7)
    cfg = TrainConfig(model=NATIVE, optim=OptimConfig(epochs=1))
    ckpt = Checkpointer(str(tmp_path))
    state, _ = train_model(*_loaders(guitarset, train, val), cfg, device="cpu",
                           checkpointer=ckpt, log=lambda s: None)
    meta = json.loads(open(ckpt.meta_path).read())
    assert meta["epoch"] == 0 and meta["step"] == 1 and meta["model"]["arch"] == "resnet18_native"
    assert set(meta["metrics"]) == {"loss", "per_string_accuracy", "accuracy"}
    fresh = create_train_state(build_model(NATIVE, generator=torch.Generator().manual_seed(9)),
                               cfg.optim, device="cpu")
    fresh, meta2 = ckpt.restore(fresh, expect_model=dataclasses.asdict(NATIVE))
    assert meta2 == meta and fresh.step == 1
    for a, b in ((fresh.params, state.params), (fresh.buffers, state.buffers),
                 (fresh.opt_state.mu, state.opt_state.mu), (fresh.opt_state.nu, state.opt_state.nu),
                 (fresh.opt_state.count, state.opt_state.count)):
        assert torch.equal(a, b)
    sd = load_torch_checkpoint(ckpt.path)
    assert sd.keys() == state.model.state_dict().keys()
    assert any("running_mean" in k for k in sd)
    for form in (os.path.join(str(tmp_path), ckpt.name), ckpt.path):
        assert find_checkpoint(form).path == ckpt.path
    for form in (str(tmp_path), str(tmp_path / "missing.pt"), str(tmp_path / "no" / "ck")):
        assert find_checkpoint(form) is None
    assert not os.path.exists(tmp_path / "no")


def test_checkpoint_mismatch_errors(tmp_path):
    """A different arch is a named CheckpointMismatchError from the meta; a
    checkpoint without meta fails on its state dict with the same error;
    an Orbax directory of the JAX package is refused by name."""
    ckpt = Checkpointer(str(tmp_path))
    state = create_train_state(build_model(NATIVE), OptimConfig(), device="cpu")
    ckpt.save(state, epoch=0, metrics={"loss": 1.0}, model_meta=dataclasses.asdict(NATIVE))
    other = ModelConfig(arch="resnet18", dtype="float32")
    target = create_train_state(build_model(other), OptimConfig(), device="cpu")
    with pytest.raises(CheckpointMismatchError, match="resnet18_native"):
        ckpt.restore(target, expect_model=dataclasses.asdict(other))
    os.remove(ckpt.meta_path)
    with pytest.raises(CheckpointMismatchError, match="does not match"):
        ckpt.restore(target, expect_model=dataclasses.asdict(other))
    orbax = Checkpointer(str(tmp_path / "jax"), "best")
    os.makedirs(orbax.orbax_path)
    assert orbax.exists()
    with pytest.raises(OrbaxCheckpointError, match="Orbax"):
        orbax.restore(target)


def test_step_generator_and_key_sequence_are_reproducible():
    g1 = prng.step_generator(42, 7)
    g2 = prng.step_generator(42, 7, generator=torch.Generator())
    assert torch.equal(torch.rand(5, generator=g1), torch.rand(5, generator=g2))
    assert prng.fold_in(42, 7) != prng.fold_in(42, 8) != prng.fold_in(43, 7)
    assert 0 <= prng.fold_in(2**70, -1) < 2**63
    a, b = prng.KeySequence(3), prng.KeySequence(3)
    x = [torch.rand(2, generator=a("dropout")) for _ in range(2)]
    assert torch.equal(x[0], torch.rand(2, generator=b("dropout")))
    assert not torch.equal(x[0], x[1])
    assert math.isfinite(float(torch.rand((), generator=prng.set_seed(1))))
