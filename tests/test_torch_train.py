"""The port's loss, BatchNorm train mode, dropout, optimizer and train/eval
steps held to the JAX package on the same NumPy weights and inputs.

Tolerances are the repo's own: the train step's loss to rtol 1e-5 and the
parameters to atol 1e-5 (tests/test_parallel.py:70-75); running statistics
to 1e-5 (tests/test_stem_pallas.py:251-260).  Both frameworks compute in
fp32 here and differ in summation order only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from guitar_tablature_classification_tpu.config import OptimConfig as JaxOptimConfig
from guitar_tablature_classification_tpu.models.heads import StringBranchHeads as JaxHeads
from guitar_tablature_classification_tpu.models.resnet import ResNet18 as JaxResNet18
from guitar_tablature_classification_tpu.ops import label_smoothing_loss as jax_loss
from guitar_tablature_classification_tpu.ops import per_string_accuracy as jax_accuracy
from guitar_tablature_classification_tpu.train import create_train_state as jax_create_state
from guitar_tablature_classification_tpu.train import make_optimizer as jax_make_optimizer
from guitar_tablature_classification_tpu.train import make_preprocess as jax_make_preprocess
from guitar_tablature_classification_tpu.train import make_train_step as jax_make_train_step
from guitar_tablature_classification_tpu_torch.config import ModelConfig, OptimConfig
from guitar_tablature_classification_tpu_torch.models import (
    adam_state_from_optax,
    build_model,
    state_dict_from_flax,
)
from guitar_tablature_classification_tpu_torch.models.heads import Dropout
from guitar_tablature_classification_tpu_torch.models.resnet import FlaxBatchNorm
from guitar_tablature_classification_tpu_torch.ops.loss import (
    label_smoothing_loss,
    per_string_accuracy,
    smoothed_true_dist,
)
from guitar_tablature_classification_tpu_torch.train import (
    create_train_state,
    make_eval_step,
    make_optimizer,
    make_preprocess,
    make_train_step,
)

NATIVE = ModelConfig(arch="resnet18_native", dtype="float32")


def _logits_case(seed=0, batch=8):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((batch, 6, 19)) * 3).astype(np.float32)
    targets = rng.integers(-2, 21, (batch, 6)).astype(np.int32)  # some out of range
    weights = (rng.uniform(0, 1, (batch, 6)) > 0.3).astype(np.float32)
    return logits, targets, weights


# ---------------------------------------------------------------------- loss


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("smoothing", [0.05, 0.1])
def test_loss_matches_jax(weighted, smoothing):
    logits, targets, weights = _logits_case()
    w = weights if weighted else None
    want = float(jax_loss(jnp.asarray(logits), jnp.asarray(targets), smoothing,
                          weights=None if w is None else jnp.asarray(w)))
    got = float(label_smoothing_loss(
        torch.from_numpy(logits), torch.from_numpy(targets), smoothing,
        weights=None if w is None else torch.from_numpy(w)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_loss_all_weights_zero_is_finite():
    logits, targets, _ = _logits_case(seed=1)
    got = label_smoothing_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                               weights=torch.zeros(8, 6))
    assert float(got) == 0.0


def test_smoothed_distribution_overwrites_the_target_cell():
    """Every cell gets s/(C-1), then the target cell is overwritten with
    1 - s (not raised by it), as the JAX function does.  The row then sums
    to 1 - s + (C-1)*s/(C-1) = 1; the JAX docstring's
    1 + s/(C-1) - s is the sum before the overwrite minus s, not the row
    sum (ROADMAP C)."""
    from guitar_tablature_classification_tpu.ops.loss import smoothed_true_dist as jax_dist

    targets = np.array([[0, 18, 7]])
    dist = smoothed_true_dist(torch.from_numpy(targets), 19, 0.05)
    np.testing.assert_allclose(dist.numpy(), np.asarray(jax_dist(jnp.asarray(targets), 19, 0.05)),
                               rtol=1e-7)
    assert float(dist[0, 0, 0]) == pytest.approx(0.95)
    assert float(dist[0, 0, 1]) == pytest.approx(0.05 / 18)
    np.testing.assert_allclose(dist.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_per_string_accuracy_matches_jax():
    logits, targets, _ = _logits_case(seed=2)
    targets = np.clip(targets, 0, 18)
    want = jax_accuracy(jnp.asarray(logits), jnp.asarray(targets))
    got = per_string_accuracy(torch.from_numpy(logits), torch.from_numpy(targets))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6)
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-6)


# ----------------------------------------------------------------- batchnorm


@pytest.mark.parametrize("shape", [(6, 5, 4, 3), (8, 16)])
def test_batchnorm_train_mode_matches_flax(shape):
    """Train-mode output, running statistics (biased variance, momentum
    0.9) and input/scale/bias gradients against Flax nn.BatchNorm."""
    rng = np.random.default_rng(3)
    c = shape[1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    ra_mean = rng.standard_normal(c).astype(np.float32)
    ra_var = rng.uniform(0.5, 2, c).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    xl = np.moveaxis(x, 1, -1)  # Flax: channels last
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": ra_mean, "var": ra_var}}

    def f(x, params):
        y, upd = bn.apply({**variables, "params": params}, x, mutable=["batch_stats"])
        return jnp.sum(y * np.moveaxis(g, 1, -1)), upd

    (_, upd), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(xl), variables["params"])
    want_y = np.moveaxis(np.asarray(bn.apply(variables, xl, mutable=["batch_stats"])[0]), -1, 1)

    mod = FlaxBatchNorm(c)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(scale))
        mod.bias.copy_(torch.from_numpy(bias))
        mod.running_mean.copy_(torch.from_numpy(ra_mean))
        mod.running_var.copy_(torch.from_numpy(ra_var))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = mod.train()(xt)
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), want_y, atol=1e-5)
    for name, got, key in (("mean", mod.running_mean, "mean"), ("var", mod.running_var, "var")):
        np.testing.assert_allclose(got.numpy(), np.asarray(upd["batch_stats"][key]),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(xt.grad.numpy(), np.moveaxis(np.asarray(grads[0]), -1, 1),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(mod.weight.grad.numpy(), np.asarray(grads[1]["scale"]),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(mod.bias.grad.numpy(), np.asarray(grads[1]["bias"]),
                               atol=1e-4, rtol=1e-4)
    # the trap: torch's own BatchNorm would store the unbiased variance
    n = x.size // c
    biased = x.swapaxes(0, 1).reshape(c, -1).var(axis=1)
    np.testing.assert_allclose(mod.running_var.numpy(), 0.9 * ra_var + 0.1 * biased, rtol=1e-5)
    assert not np.allclose(biased, biased * n / (n - 1))


# ------------------------------------------------------------------- dropout


def test_dropout_rate_scale_and_reproducibility():
    drop = Dropout(0.3).train()
    x = torch.ones(400, 500)
    a = drop(x, torch.Generator().manual_seed(7))
    b = drop(x, torch.Generator().manual_seed(7))
    c = drop(x, torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.005  # 200k draws: ~5 sigma
    np.testing.assert_allclose(a[kept].numpy(), 1 / 0.7, rtol=1e-6)
    assert torch.equal(drop.eval()(x), x)
    with pytest.raises(ValueError, match="Generator"):
        drop.train()(x)


def test_model_dropout_comes_from_the_step_generator():
    model = build_model(NATIVE).train()
    x = torch.rand(8, 96, 9, 1)
    runs = []
    for seed in (1, 1, 2):
        torch.manual_seed(123)  # the global RNG must not matter
        runs.append(model(x, torch.Generator().manual_seed(seed)).detach())
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])


# ----------------------------------------------------------------- optimizer


@pytest.mark.parametrize("cfg_kw", [
    {}, {"name": "adamw"}, {"backbone_lr_scale": 0.1}, {"grad_clip_norm": 0.0},
])
def test_optimizer_matches_optax(cfg_kw):
    """Three updates of the flat optimizer against the JAX package's optax
    chain; the gradients are large enough that the clip engages."""
    rng = np.random.default_rng(4)
    shapes = {"resnet": {"w": (5, 3)}, "heads": {"w": (4,), "b": (2, 2)}}
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                          is_leaf=lambda s: isinstance(s, tuple))
    grads = [jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
             for _ in range(3)]
    jcfg = JaxOptimConfig(**cfg_kw)
    tx = jax_make_optimizer(jcfg, params)
    state, p = tx.init(params), params
    names = ["resnet.w", "heads.w", "heads.b"]
    leaf = lambda tree, n: tree[n.split(".")[0]][n.split(".")[1]]  # noqa: E731
    flat = lambda tree: torch.cat([torch.from_numpy(np.asarray(leaf(tree, n))).reshape(-1)  # noqa: E731
                                   for n in names])
    port = make_optimizer(OptimConfig(**cfg_kw), names,
                          [int(np.prod(leaf(shapes, n))) for n in names])
    tp = flat(params)
    tstate = port.init(tp)
    for g in grads:
        state.hyperparams["learning_rate"] = jnp.asarray(1e-2)
        upd, state = tx.update(g, state, p)
        p = jax.tree.map(lambda a, b: a + b, p, upd)
        tp, tstate, _ = port.update(flat(g), tstate, tp, 1e-2)
    np.testing.assert_allclose(tp.numpy(), flat(p).numpy(), rtol=1e-6, atol=1e-7)
    adam = next(s for s in jax.tree_util.tree_leaves(state, is_leaf=lambda s: hasattr(s, "mu"))
                if hasattr(s, "mu"))
    np.testing.assert_allclose(tstate.mu.numpy(), flat(adam.mu).numpy(), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(tstate.nu.numpy(), flat(adam.nu).numpy(), rtol=1e-6, atol=1e-9)
    assert int(tstate.count) == int(adam.count) == 3


# ---------------------------------------------------------------- train step


class _NoDropoutTabNet(fnn.Module):
    """The JAX GuitarTabNet for resnet18_native with its heads' dropout at
    0, under the same variable names (resnet / heads), so the train step is
    deterministic on both sides."""

    @fnn.compact
    def __call__(self, x, train: bool = False):
        feats = JaxResNet18(num_features=256, input_channels=1, dtype=jnp.float32,
                            name="resnet")(x, train=train)
        return JaxHeads(dropout=(0.0, 0.0), name="heads")(feats, train=train)


def _batch(seed, batch=8):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-120, 0, (batch, 96, 9)).astype(np.float32),
            rng.integers(0, 19, (batch, 6)).astype(np.int32))


def _port_state(variables, cfg=NATIVE):
    model = build_model(cfg)
    model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, variables)),
                          strict=True)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0  # neutralised in this test only, as on the JAX side
    state = create_train_state(model, OptimConfig(), device="cpu")
    return model, state


def _assert_state_matches(state, jstate, steps, lr, running_atol=1e-5, zero_grad=()):
    """Parameters, running averages and Adam moments against the JAX state.

    - Running averages: atol ``running_atol`` (1e-5 by default).
    - Parameters: atol 1e-5 (tests/test_parallel.py:70-75), except where
      Adam's scale-free update turns fp32 noise into a sign.  An element
      whose gradient lies within the two frameworks' disagreement of zero
      moves by +-lr either way.  Those elements must stay rare (at most
      1e-3 of them) and within 2*lr per step.
    - Moments: per tensor, relative L2 error at most 1e-2.  In train mode
      Flax's fast variance E[x^2] - E[x]^2 amplifies fp32 summation-order
      noise at every batch-statistics BatchNorm, so train-mode gradients of
      the two frameworks agree far less closely than eval-mode logits.
    - ``zero_grad``: parameters whose gradient is zero in exact arithmetic
      (a bias feeding a batch-statistics BatchNorm: the BatchNorm's
      backward sums to zero over the batch).  Their gradients are fp32
      noise on both sides, so each of their elements may move by the whole
      +-lr of a sign flip, and their moments must stay at the noise floor
      (1e-4 of the largest moment of the model) instead of agreeing."""
    sd = state.model.state_dict()
    want = state_dict_from_flax(jax.tree.map(
        np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    diffs = []
    for key, val in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        d = np.abs(sd[key].numpy() - val.numpy())
        if "running" in key:
            assert d.max() <= running_atol, f"step {steps}: {key} off by {d.max()}"
        elif key in zero_grad:
            assert d.max() <= 2 * lr * steps + 1e-5, f"step {steps}: {key} off by {d.max()}"
        else:
            diffs.append(d.ravel())
    diffs = np.concatenate(diffs)
    assert (diffs > 1e-5).mean() <= 1e-3, (diffs > 1e-5).mean()
    assert diffs.max() <= 2 * lr * steps + 1e-5, diffs.max()
    adam = adam_state_from_optax(jstate.opt_state)
    mine = state.adam_state()
    assert mine["count"] == adam["count"] == steps
    for kind in ("mu", "nu"):
        floor = 1e-4 * max(float(np.abs(v.numpy()).max()) for v in adam[kind].values())
        for name, val in adam[kind].items():
            ref = val.numpy()
            if name in zero_grad:
                for side in (ref, mine[kind][name].numpy()):
                    assert np.abs(side).max() <= floor, f"step {steps}: {kind} {name} not ~0"
                continue
            err = np.linalg.norm(mine[kind][name].numpy() - ref) / np.linalg.norm(ref)
            assert err <= 1e-2, f"step {steps}: {kind} {name} relative error {err}"


@pytest.mark.parametrize("steps, lr", [(1, 5e-4), (3, 1e-5)])
def test_train_step_matches_jax(steps, lr):
    """resnet18_native at fp32, B=8: loss (rtol 1e-5) and the raw
    gradients' norm (rtol 1e-3) at every step, then the state as
    :func:`_assert_state_matches` says.  Three steps run at lr 1e-5: at
    larger rates the trajectory itself is chaotic (the JAX model alone
    moves its next gradients by percents when a few of its parameters move
    by 2*lr), so fp32 noise would not stay at fp32 size."""
    jmodel = _NoDropoutTabNet()
    jpre = jax_make_preprocess(ModelConfig(arch="resnet18_native", dtype="float32"))
    feats, _ = _batch(0)
    jstate = jax_create_state(jmodel, JaxOptimConfig(), jax.random.PRNGKey(0),
                              jpre(jnp.asarray(feats[:1])))
    model, state = _port_state({"params": jstate.params, "batch_stats": jstate.batch_stats})
    jstep = jax_make_train_step(jmodel, jpre)
    step = make_train_step(model, make_preprocess(NATIVE))
    gen = torch.Generator().manual_seed(0)
    for i in range(steps):
        feats, labels = _batch(i)
        jstate, jm = jstep(jstate, {"features": jnp.asarray(feats), "labels": jnp.asarray(labels)},
                           jax.random.PRNGKey(1), lr)
        m = step(state, {"features": torch.from_numpy(feats),
                         "labels": torch.from_numpy(labels)}, gen, lr)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-3)
        np.testing.assert_allclose(m["per_string_accuracy"].numpy(),
                                   np.asarray(jm["per_string_accuracy"]), atol=1e-6)
    _assert_state_matches(state, jstate, steps, lr)
    assert state.step == steps


def test_train_step_skips_nonfinite_loss():
    """A NaN in the features: the loss is not finite, parameters, moments
    and running averages stay as they were, and step still advances
    (after tests/test_train.py:70)."""
    model = build_model(NATIVE)
    state = create_train_state(model, OptimConfig(), device="cpu")
    step = make_train_step(model, make_preprocess(NATIVE))
    feats, labels = _batch(1)
    gen = torch.Generator().manual_seed(0)
    step(state, {"features": torch.from_numpy(feats), "labels": torch.from_numpy(labels)},
         gen, 1e-3)
    before = [t.clone() for t in (state.params, state.buffers, state.opt_state.mu,
                                  state.opt_state.nu, state.opt_state.count)]
    feats[0, 0, 0] = np.nan
    m = step(state, {"features": torch.from_numpy(feats), "labels": torch.from_numpy(labels)},
             gen, 1e-3)
    assert not np.isfinite(float(m["loss"]))
    after = (state.params, state.buffers, state.opt_state.mu, state.opt_state.nu,
             state.opt_state.count)
    for a, b in zip(before, after):
        assert torch.equal(a, b)
    assert state.step == 2
    # the model's own tensors are views of the state's buffers
    assert torch.equal(model.resnet.bn1.running_var, before[1][64:128])


def test_eval_step_respects_padding_weights():
    """Rows with zero weight do not count (after tests/test_train.py:320)."""
    model = build_model(NATIVE)
    state = create_train_state(model, OptimConfig(), device="cpu")
    eval_step = make_eval_step(model, make_preprocess(NATIVE))
    feats, labels = _batch(2, batch=16)
    w = np.ones((16, 6), np.float32)
    w[8:] = 0.0
    masked = eval_step(state, {"features": torch.from_numpy(feats),
                               "labels": torch.from_numpy(labels),
                               "weights": torch.from_numpy(w)})
    small = eval_step(state, {"features": torch.from_numpy(feats[:8]),
                              "labels": torch.from_numpy(labels[:8])})
    np.testing.assert_allclose(float(masked["accuracy"]), float(small["accuracy"]), atol=1e-6)
    np.testing.assert_allclose(float(masked["loss"]), float(small["loss"]), rtol=1e-5)
    np.testing.assert_allclose(masked["correct"].numpy(), small["correct"].numpy(), atol=1e-5)
    assert float(masked["count"].sum()) == 48


def test_adam_state_round_trips_through_the_state():
    model = build_model(NATIVE)
    state = create_train_state(model, OptimConfig(), device="cpu")
    rng = np.random.default_rng(5)
    moments = {"count": 4, **{
        kind: {n: torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
               for n, p in model.named_parameters()}
        for kind in ("mu", "nu")}}
    state.load_adam_state(moments)
    got = state.adam_state()
    assert got["count"] == 4
    for kind in ("mu", "nu"):
        for name, val in moments[kind].items():
            assert torch.equal(got[kind][name], val), name


def test_create_train_state_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default is tested where there is none")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_train_state(build_model(NATIVE), OptimConfig())
