"""The port's ``parallel/`` (mesh over ranks, string-head sharding, the
cross-rank BatchNorm reductions) and its data- and string-parallel steps,
held to the one-process step and to the JAX package's 8-device mesh step.

Two ``gloo`` processes on the CPU run every mesh case once (this file run
as a script is the worker); the tests read what they wrote.  Tolerances:
the JAX mesh tests' own (tests/test_parallel.py:70-75,184: loss rtol 1e-5,
head kernels atol 1e-5; serving :403: logits atol 1e-5, frets equal), and
1e-5 for the BatchNorm Functions on half batches against one process on
the whole.  Against the one-process step the rest of the state is held as
tests/test_torch_train.py holds the port to JAX (Adam turns fp32
summation-order noise in a near-zero gradient into a +-lr sign).
"""

from __future__ import annotations

import copy
import functools
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from guitar_tablature_classification_tpu_torch.config import (
    CQTConfig,
    MeshConfig,
    ModelConfig,
    OptimConfig,
)
from guitar_tablature_classification_tpu_torch.models import build_model
from guitar_tablature_classification_tpu_torch.models.heads import Dropout, StringElsewhere
from guitar_tablature_classification_tpu_torch.parallel import (
    batch_sharding,
    make_mesh,
    param_shardings,
    shard_batch,
    shard_model,
    string_param_names,
    use_mesh,
)
from guitar_tablature_classification_tpu_torch.train import (
    create_train_state,
    make_preprocess,
    make_train_step,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
LR = 1e-3
SMALL = ModelConfig(arch="small_cnn", dtype="float32")
NATIVE = ModelConfig(arch="resnet18_native", stem_fusion="fused", bn_fusion="on",
                     dtype="float32")
MESHES = {"dp": MeshConfig(), "mp": MeshConfig(model_parallel=2)}
STEPS = [(arch, mesh, dropout) for arch in ("small", "native") for mesh in MESHES
         for dropout in (False, True)]
BN_CASES = ("flax", "fused", "stem_tail", "stem_native")
WORKER_TIMEOUT = 300  # s; two ranks take ~12 s alone, several times that on a loaded host
# One intra-op thread a rank.  With two, MKL's CPU sqrt (VML) has returned,
# rarely and only on a loaded host, other bits for one thread's half of the
# first Adam update's sqrt(nu_hat) than a second call on the same input
# gives, so the ranks' parameters, computed from bit-equal gradients,
# differed.  On one thread each rank's arithmetic is its own and repeatable.
WORKER_THREADS = 1


# ------------------------------------------------------------ shared cases


def _batch(seed: int, batch: int = 8):
    rng = np.random.default_rng(seed)
    return {"features": rng.uniform(-120, 0, (batch, 96, 9)).astype(np.float32),
            "labels": rng.integers(0, 19, (batch, 6)).astype(np.int64)}


@functools.lru_cache(maxsize=None)
def _built(cfg):
    return build_model(cfg)


def _step(cfg, sd, dropout: bool, mesh=None) -> dict:
    """One train step of ``cfg`` from the weights ``sd`` on the batch of
    seed 0 (this rank's rows under ``mesh``): the metrics and the model's
    state dict after it (the parameters are views of the state's flat
    buffer, so the state dict holds every updated value once)."""
    model = copy.deepcopy(_built(cfg))
    model.load_state_dict(sd, strict=True)
    if not dropout:
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
    state = create_train_state(model, OptimConfig(), device="cpu", mesh=mesh)
    batch = _batch(0)
    batch = shard_batch(mesh, batch) if mesh is not None else \
        {k: torch.from_numpy(v) for k, v in batch.items()}
    m = make_train_step(model, make_preprocess(cfg), mesh=mesh)(
        state, batch, torch.Generator().manual_seed(3), LR)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "per_string_accuracy": m["per_string_accuracy"].numpy(),
            "sd": {k: v.detach().clone() for k, v in model.state_dict().items()}}


def _bn_case(name: str, mesh=None) -> dict:
    """A patched training BatchNorm Function on a seeded global batch of 8
    (this rank's rows under ``mesh``): its output, statistics and the
    gradients of sum(out * g)."""
    from guitar_tablature_classification_tpu_torch.models.resnet import FlaxBatchNorm
    from guitar_tablature_classification_tpu_torch.ops import bn_fused, stem_native, stem_tail

    rng = np.random.default_rng(BN_CASES.index(name))
    c = 16
    shapes = {"flax": (8, c, 5, 5), "fused": (8, c, 5, 5), "stem_tail": (8, 8, 8, c),
              "stem_native": (8, 6, 6 * c)}
    x = rng.standard_normal(shapes[name]).astype(np.float32) * 2 + 0.5
    scale = torch.tensor(rng.uniform(0.5, 1.5, c), dtype=torch.float32, requires_grad=True)
    bias = torch.tensor(rng.standard_normal(c) * 0.1, dtype=torch.float32, requires_grad=True)
    rows = batch_sharding(mesh, 8) if mesh is not None else slice(None)

    def local(a):
        return torch.tensor(a[rows], requires_grad=True)

    inputs = [local(x)]
    bn = None
    with use_mesh(mesh):
        if name == "flax":
            bn = FlaxBatchNorm(c)
            with torch.no_grad():
                bn.weight.copy_(scale)
                bn.bias.copy_(bias)
            scale, bias = bn.weight, bn.bias
            out, mean, var = bn.train()(inputs[0]), bn.running_mean, bn.running_var
        elif name == "fused":
            out, mean, var = bn_fused.batch_norm_train(inputs[0], scale, bias)
        elif name == "stem_tail":
            inputs = [local(stem_tail.quadrant_pack(torch.from_numpy(x)).numpy())]
            out, mean, var = stem_tail.bn_relu_pool_train(inputs[0], scale, bias)
        else:
            y2 = rng.standard_normal(shapes[name]).astype(np.float32)
            inputs = [local(x), local(y2)]
            out, mean, var = stem_native.native_bn_relu_pool_train(
                inputs[0], inputs[1], scale, bias, 5)
        g = np.random.default_rng(9).standard_normal((8,) + tuple(out.shape[1:]))
        (out * torch.tensor(g[rows], dtype=out.dtype)).sum().backward()
    return {"out": out.detach(), "mean": mean.detach().clone(), "var": var.detach().clone(),
            "dx": [t.grad for t in inputs], "dscale": scale.grad, "dbias": bias.grad}


def _train(ckpt_dir: str | None, mesh=None) -> dict:
    """``train_model`` for 2 epochs of small_cnn (two train batches of 8,
    one val batch, dropout on), with a checkpointer under ``mesh``: the
    history and the returned state's parameters."""
    from guitar_tablature_classification_tpu_torch.config import DataConfig, TrainConfig
    from guitar_tablature_classification_tpu_torch.train import Checkpointer, train_model

    cfg = TrainConfig(model=SMALL, optim=OptimConfig(epochs=2, seed=0),
                      data=DataConfig(batch_size=8))
    train = [_batch(1), _batch(2)]
    ckpt = Checkpointer(ckpt_dir, "best") if ckpt_dir else None
    state, history = train_model(train, [_batch(3)], cfg, model=copy.deepcopy(_built(SMALL)),
                                 checkpointer=ckpt, log=lambda line: None, device="cpu",
                                 mesh=mesh)
    return {"history": {k: history[k] for k in ("train_loss", "val_loss", "val_accuracy")},
            "params": state.params.clone()}


def _serve(mesh=None) -> dict:
    from guitar_tablature_classification_tpu_torch.data.synthetic import render_performance
    from guitar_tablature_classification_tpu_torch.infer import Transcriber

    cfg = CQTConfig()
    audio = render_performance([(0, 3, 0.1, 0.8)], 1.5, cfg)
    t = Transcriber(None, model_cfg=SMALL, cqt_cfg=cfg, batch_size=8, device="cpu", seed=0,
                    mesh=mesh)
    r = t.transcribe(audio, keep_logits=True)
    return {"frets": r.frets, "logits": r.logits, "buckets": t.bucket_sizes}


# ------------------------------------------------------------------ worker


def worker(rank: int, port: int, out_dir: str) -> None:
    """One of WORLD gloo ranks: every mesh case of this file."""
    import torch.distributed as dist

    torch.set_num_threads(WORKER_THREADS)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=WORLD)
    case = torch.load(os.path.join(out_dir, "case.pt"), weights_only=False)
    meshes = {k: make_mesh(v, device="cpu") for k, v in MESHES.items()}
    out = {"bn": {n: _bn_case(n, meshes["dp"]) for n in BN_CASES}, "steps": {}}
    for arch, mesh, dropout in STEPS:
        cfg = SMALL if arch == "small" else NATIVE
        out["steps"][arch, mesh, dropout] = _step(cfg, case[arch], dropout, meshes[mesh])
    out["serve"] = _serve(meshes["dp"])
    out["train"] = _train(os.path.join(out_dir, "ckpt"), meshes["dp"])
    dist.barrier()
    out["train"]["ckpt_files"] = sorted(os.listdir(os.path.join(out_dir, "ckpt")))
    out["strings"] = meshes["mp"].strings
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------- fixtures


def _launch(weights: dict, out_dir: str) -> list[subprocess.Popen]:
    torch.save(weights, os.path.join(out_dir, "case.pt"))
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": str(WORKER_THREADS)}
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), "worker", str(r),
                              str(port), out_dir], cwd=ROOT, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(WORLD)]


def _wait(procs: list[subprocess.Popen], out_dir: str) -> list[dict]:
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT)[0].decode())
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)]


def _flax_variables(arch: str, sd: dict) -> dict:
    """The port's state dict as the JAX model's variables: GuitarTabNet's
    (``arch`` "native", any input width) through the JAX package's own
    importer, small_cnn's by hand (Flax kernels are HWIO where the port's
    convs are OIHW)."""
    from guitar_tablature_classification_tpu.models.torch_import import (
        guitartabnet_variables_from_torch,
    )

    sd = {k: v.numpy() for k, v in sd.items()}
    if arch == "native":
        return guitartabnet_variables_from_torch(sd)
    params = {}
    for name in ("conv1", "conv2", "conv3", "dense0", "dense1", "out"):
        w = sd[f"{name}.weight"]
        params[name] = {"kernel": w.transpose(2, 3, 1, 0) if w.ndim == 4 else w,
                        "bias": sd[f"{name}.bias"]}
    return {"params": params, "batch_stats": {}}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The port's seeded weights of both models; both gloo ranks' results
    of :func:`worker` from them; and, computed while the ranks run, the JAX
    step (heads' dropout at 0) from the same weights on the 8-device CPU
    mesh (data 4 x model 2: XLA's SPMD partitioning computes one function
    whatever the mesh's shape, and this one splits both axes)."""
    import jax
    import jax.numpy as jnp

    from guitar_tablature_classification_tpu.config import MeshConfig as JaxMeshConfig
    from guitar_tablature_classification_tpu.config import OptimConfig as JaxOptimConfig
    from guitar_tablature_classification_tpu.models.small_cnn import SmallTabCNN
    from guitar_tablature_classification_tpu.parallel import make_mesh as jax_make_mesh
    from guitar_tablature_classification_tpu.parallel import param_shardings as jax_shardings
    from guitar_tablature_classification_tpu.parallel import shard_batch as jax_shard_batch
    from guitar_tablature_classification_tpu.train import make_optimizer as jax_optimizer
    from guitar_tablature_classification_tpu.train import make_preprocess as jax_pre
    from guitar_tablature_classification_tpu.train import make_train_step as jax_step
    from guitar_tablature_classification_tpu.train.engine import TrainState as JaxTrainState
    from guitar_tablature_classification_tpu_torch.models import state_dict_from_flax
    from test_torch_stem_native import _jax_native_net

    cfgs = {"small": SMALL, "native": NATIVE}
    weights = {arch: _built(cfg).state_dict() for arch, cfg in cfgs.items()}
    out_dir = str(tmp_path_factory.mktemp("gloo"))
    procs = _launch(weights, out_dir)
    out = {"weights": weights}
    try:
        batch = {k: jnp.asarray(v.astype(np.int32) if k == "labels" else v)
                 for k, v in _batch(0).items()}
        jcfg = JaxMeshConfig(model_parallel=2)
        mesh = jax_make_mesh(jcfg)
        models = {"small": SmallTabCNN(dtype=jnp.float32, dropout=(0.0, 0.0)),
                  "native": _jax_native_net(True)}
        for arch, jmodel in models.items():
            variables = jax.tree.map(jnp.asarray, _flax_variables(arch, weights[arch]))
            tx = jax_optimizer(JaxOptimConfig(), variables["params"])
            state = JaxTrainState(
                step=jnp.zeros((), jnp.int32), params=variables["params"],
                batch_stats=variables["batch_stats"], opt_state=tx.init(variables["params"]),
                apply_fn=jmodel.apply, tx=tx)
            new, m = jax_step(jmodel, jax_pre(cfgs[arch]))(
                jax.device_put(state, jax_shardings(mesh, state, jcfg)),
                jax_shard_batch(mesh, batch, jcfg), jax.random.PRNGKey(0), LR)
            out[arch] = {"loss": float(m["loss"]), "sd": state_dict_from_flax(
                jax.tree.map(np.asarray, {"params": new.params, "batch_stats": new.batch_stats}))}
    finally:
        out["ranks"] = _wait(procs, out_dir)
    return out


@pytest.fixture(scope="module")
def ranks(case):
    return case["ranks"]


# ----------------------------------------------------------- mesh planning


def test_make_mesh_shapes_and_its_value_error():
    """The JAX mesh's shapes (tests/test_parallel.py:41-47) over 8 ranks,
    planned without processes, and its ValueError."""
    assert make_mesh(MeshConfig(), 8, device="cpu").shape == {"data": 8, "model": 1}
    mesh = make_mesh(MeshConfig(model_parallel=2), 8, rank=5, device="cpu")
    assert mesh.shape == {"data": 4, "model": 2}
    assert (mesh.data_index, mesh.model_index, mesh.strings) == (2, 1, (3, 6))
    assert make_mesh(device="cpu").shape == {"data": 1, "model": 1}  # one process
    with pytest.raises(ValueError, match="does not cover 8 devices"):
        make_mesh(MeshConfig(data_parallel=3, model_parallel=2), 8, device="cpu")
    assert make_mesh(MeshConfig(model_parallel=4), 8, device="cpu").strings is None  # 6 % 4
    assert batch_sharding(mesh, 16) == slice(8, 12)
    with pytest.raises(ValueError, match="not divisible by the data axis"):
        batch_sharding(mesh, 6)


@pytest.mark.parametrize("mp", [2, 3, 6])
def test_param_shardings_slices_every_string_stacked_tensor(mp):
    """At mp = 2, 3 and 6: each model rank's part of ``StackedDense``'s
    [6, ...] tensors (JAX's shape rule: small_cnn) and of the per-string
    branches (GuitarTabNet's heads);
    together the ranks hold every string once, and ``shard_model`` keeps
    the global names and leaves the trunk whole."""
    from guitar_tablature_classification_tpu_torch.models.heads import StringBranchHeads

    k = 6 // mp
    heads = torch.nn.Module()  # GuitarTabNet's heads, under their name, beside a trunk
    heads.trunk, heads.branches = torch.nn.Linear(4, 256), StringBranchHeads()
    for cfg in (SMALL, NATIVE):
        base = build_model(cfg) if cfg is SMALL else heads
        full = base.state_dict()
        held = {}
        for m in range(mp):
            mesh = make_mesh(MeshConfig(model_parallel=mp), 2 * mp, rank=mp + m, device="cpu")
            assert mesh.strings == (m * k, (m + 1) * k)
            parts = param_shardings(mesh, base)
            assert parts
            for name, part in parts.items():
                if cfg is SMALL:
                    torch.testing.assert_close(part, full[name][m * k:(m + 1) * k], rtol=0,
                                               atol=0)
                else:
                    s = int(name.split(".")[1])
                    assert (part is None) == (not m * k <= s < (m + 1) * k), name
                    if part is not None:
                        held[name] = part
            model = shard_model(mesh, copy.deepcopy(base))
            sd = model.state_dict()
            assert set(sd) <= set(full)
            for name, t in sd.items():
                if name in parts:
                    torch.testing.assert_close(t, parts[name], rtol=0, atol=0)
                else:
                    torch.testing.assert_close(t, full[name], rtol=0, atol=0)
            assert string_param_names(model) == {n for n in parts if parts[n] is not None
                                                 and n in dict(model.named_parameters())}
            if cfg is NATIVE:
                assert sum(isinstance(b, StringElsewhere) for b in model.branches) == 6 - k
        if cfg is NATIVE:
            assert set(held) == {n for n in full if n.startswith("branches.")}


# ------------------------------------------------------ two gloo processes


@pytest.mark.parametrize("name", BN_CASES)
def test_bn_function_on_half_batches_matches_one_process(ranks, name):
    """Each patched BatchNorm Function under a dp=2 mesh, each rank on its
    half of the batch, against one process on the whole, at 1e-5: the
    output and input gradient by rows, the (global) statistics on both
    ranks, and the scale and bias gradients as the sum of the ranks'
    parts (the step sums them)."""
    want = _bn_case(name)
    got = [r["bn"][name] for r in ranks]
    tol = dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(torch.cat([g["out"] for g in got]), want["out"], **tol)
    for i in range(len(want["dx"])):
        torch.testing.assert_close(torch.cat([g["dx"][i] for g in got]), want["dx"][i], **tol)
    for g in got:
        torch.testing.assert_close(g["mean"], want["mean"], **tol)
        torch.testing.assert_close(g["var"], want["var"], **tol)
    for key in ("dscale", "dbias"):
        torch.testing.assert_close(got[0][key] + got[1][key], want[key], **tol)


def _assemble(ranks_sd: list[dict], full: dict) -> dict:
    """Both ranks' state dicts as one: a tensor the ranks split by strings
    (rows of a [6, ...] tensor, or branches) joined, a shared one taken
    from rank 0 after checking that rank 1 holds the same bits."""
    out = {}
    for key, want in full.items():
        have = [sd[key] for sd in ranks_sd if key in sd]
        if len(have) == 1:
            out[key] = have[0]
        elif have[0].shape != want.shape:
            out[key] = torch.cat(have)
        else:
            assert torch.equal(have[0], have[1]), f"{key} differs between the ranks"
            out[key] = have[0]
    return out


def _heads(sd: dict) -> dict:
    return {k: v for k, v in sd.items()
            if k.startswith(("out.", "branches.")) and k.endswith((".weight", ".8.weight"))
            and (k.startswith("out.") or ".8." in k)}


@pytest.mark.parametrize("arch, mesh, dropout", STEPS)
def test_mesh_step_matches_one_process(ranks, case, arch, mesh, dropout):
    """A dp=2 and an mp=2 step (dropout off and on) against the one-process
    step from the same weights and generator: loss rtol 1e-5, the raw
    gradients' norm rtol 1e-3 (tests/test_torch_train.py's limit: the
    batch-statistics BatchNorms amplify summation-order noise in the
    gradients), the per-string accuracy, every parameter as
    tests/test_torch_train.py allows, the running statistics atol 1e-5;
    the shared parameters bit-identical
    on both ranks, and each rank holding 3 strings under mp=2."""
    cfg = SMALL if arch == "small" else NATIVE
    want = _step(cfg, case["weights"][arch], dropout)
    got = [r["steps"][arch, mesh, dropout] for r in ranks]
    for g in got:
        np.testing.assert_allclose(g["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(g["grad_norm"], want["grad_norm"], rtol=1e-3)
        np.testing.assert_allclose(g["per_string_accuracy"], want["per_string_accuracy"],
                                   atol=1e-6)
    if mesh == "mp":
        assert [r["strings"] for r in ranks] == [(0, 3), (3, 6)]
        for g in got:
            if arch == "small":
                assert g["sd"]["out.weight"].shape[0] == 3
            else:
                assert sum(k.endswith(".8.weight") for k in g["sd"]) == 3
    else:
        assert all(torch.equal(v, got[1]["sd"][k]) for k, v in got[0]["sd"].items())
    sd = _assemble([g["sd"] for g in got], want["sd"])
    diffs = []
    for key, val in want["sd"].items():
        d = (sd[key].double() - val.double()).abs()
        if "running" in key:
            assert float(d.max()) <= 1e-5, key
        elif "num_batches" not in key:
            diffs.append(d.flatten())
    diffs = torch.cat(diffs)
    assert float((diffs > 1e-5).double().mean()) <= 1e-3
    assert float(diffs.max()) <= 2 * LR + 1e-5


@pytest.mark.parametrize("arch, mesh", [(a, m) for a in ("small", "native") for m in MESHES])
def test_mesh_step_matches_jax_mesh_step(case, arch, mesh):
    """The port's dp=2 / mp=2 step against the JAX step on the 8-device
    mesh from the same weights, dropout off on both sides: loss rtol 1e-5
    (tests/test_parallel.py:70-75,184); the head kernels atol 1e-5 for
    small_cnn, as there.  resnet18_native's batch-statistics BatchNorms
    amplify fp32 noise (tests/test_torch_train.py), and Adam's first step,
    g / (|g| + 1e-8), turns that noise in a near-zero gradient into a
    visible update: its six head kernels are held to atol 1e-5 but for at
    most 1e-3 of their elements together, each within 2 * lr (the rule of
    tests/test_torch_train.py)."""
    want = case[arch]
    got = [r["steps"][arch, mesh, False] for r in case["ranks"]]
    for g in got:
        np.testing.assert_allclose(g["loss"], want["loss"], rtol=1e-5)
    sd = _assemble([g["sd"] for g in got], want["sd"])
    heads = _heads(want["sd"])
    if arch == "small":
        for key, val in heads.items():
            torch.testing.assert_close(sd[key], val, rtol=0, atol=1e-5)
    else:
        d = torch.cat([(sd[key] - val).abs().flatten() for key, val in heads.items()])
        assert float((d > 1e-5).double().mean()) <= 1e-3 and float(d.max()) <= 2 * LR


def test_mesh_serving_matches_one_process(ranks):
    """Transcriber(mesh=...) at dp=2 against one process
    (tests/test_parallel.py:403): logits atol 1e-5, frets equal, on both
    ranks; the buckets that do not split over the data axis dropped."""
    want = _serve()
    for r in ranks:
        assert r["serve"]["buckets"] == (8,)
        np.testing.assert_allclose(r["serve"]["logits"], want["logits"], atol=1e-5)
        np.testing.assert_array_equal(r["serve"]["frets"], want["frets"])


def test_mesh_train_model_matches_one_process(ranks, tmp_path):
    """train_model under dp=2 (2 epochs, dropout on, validation each epoch)
    gives the one-process history (rtol 1e-5) and the same parameters on
    both ranks; rank 0 alone wrote the best-val checkpoint."""
    want = _train(None)
    for r in ranks:
        for key, val in want["history"].items():
            np.testing.assert_allclose(r["train"]["history"][key], val, rtol=1e-5, err_msg=key)
    assert torch.equal(ranks[0]["train"]["params"], ranks[1]["train"]["params"])
    assert ranks[0]["train"]["ckpt_files"] == ["best.meta.json", "best.pt"]
    torch.testing.assert_close(ranks[0]["train"]["params"], want["params"], rtol=0, atol=2 * LR)


def test_a_step_takes_the_states_mesh_only():
    """A step given a mesh that is not its state's raises ValueError, train
    and eval alike: over a state made without a mesh, and over a state
    made on another mesh (planned without processes)."""
    from guitar_tablature_classification_tpu_torch.train import make_eval_step

    mesh = make_mesh(MeshConfig(), 2, rank=0, device="cpu")
    other = make_mesh(MeshConfig(), 2, rank=0, device="cpu")
    batch = shard_batch(mesh, _batch(0))
    for state_mesh in (None, other):
        model = copy.deepcopy(_built(SMALL))
        state = create_train_state(model, OptimConfig(), device="cpu", mesh=state_mesh)
        with pytest.raises(ValueError, match="not the state's"):
            make_train_step(model, make_preprocess(SMALL), mesh=mesh)(
                state, batch, torch.Generator().manual_seed(3), LR)
        with pytest.raises(ValueError, match="not the state's"):
            make_eval_step(model, make_preprocess(SMALL), mesh=mesh)(state, batch)
        assert state.step == 0


def test_string_sharded_model_needs_the_mesh():
    mesh = make_mesh(MeshConfig(model_parallel=2), 2, rank=0, device="cpu")
    model = shard_model(mesh, build_model(SMALL)).eval()
    with pytest.raises(RuntimeError, match="use_mesh"):
        model(torch.zeros(1, 96, 9, 1))


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
