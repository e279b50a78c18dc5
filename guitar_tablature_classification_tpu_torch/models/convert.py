"""Weights across the two packages, and reference ``.pt`` checkpoints.

:func:`state_dict_from_flax` maps the JAX package's GuitarTabNet or ViTTab
variables (a nested dict of NumPy arrays: ``{'params': ..., 'batch_stats':
...}``) to this package's state dict.  It is the port's own copy of the
mappings in the JAX package's ``models/torch_export.py``
(``guitartabnet_state_dict``, ``vittab_state_dict``); the port does not
import that package.  The ViT's fused ``qkv`` kernel ``[D, 3D]`` splits
into Hugging Face's ``query``, ``key`` and ``value``.  A conv-stem ViT,
which has no reference layout, maps to the port's own names
(``vit.stem_conv{i}``, ``vit.stem_bn{i}``, ``vit.stem_proj``).
:func:`adam_state_from_optax` carries an optax Adam state's moments across
by the same mapping.

:func:`load_torch_checkpoint` and :func:`strip_module_prefix` read
reference ``best_guitar_tab_model.pt``-style files, as the JAX package's
``models/torch_import.py`` does.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))  # a writable copy


def _conv(out: dict, name: str, params: Mapping) -> None:
    # Flax HWIO -> torch OIHW
    out[f"{name}.weight"] = _t(np.asarray(params["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in params:
        out[f"{name}.bias"] = _t(params["bias"])


def _dense(out: dict, name: str, params: Mapping) -> None:
    out[f"{name}.weight"] = _t(np.asarray(params["kernel"]).T)
    if "bias" in params:
        out[f"{name}.bias"] = _t(params["bias"])


def _bn(out: dict, name: str, params: Mapping, stats: Mapping | None) -> None:
    out[f"{name}.weight"] = _t(params["scale"])
    out[f"{name}.bias"] = _t(params["bias"])
    if stats is None:  # a parameter-shaped tree (an optimizer moment)
        return
    out[f"{name}.running_mean"] = _t(stats["mean"])
    out[f"{name}.running_var"] = _t(stats["var"])
    out[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _ln(out: dict, name: str, params: Mapping) -> None:
    out[f"{name}.weight"] = _t(params["scale"])
    out[f"{name}.bias"] = _t(params["bias"])


def _sub(stats: Mapping | None, *keys: str) -> Mapping | None:
    for key in keys:
        stats = None if stats is None else stats[key]
    return stats


def _resnet(out: dict, params: Mapping, stats: Mapping | None, prefix: str) -> None:
    _conv(out, f"{prefix}conv1", params["conv1"])
    _bn(out, f"{prefix}bn1", params["bn1"], _sub(stats, "bn1"))
    for stage in range(1, 5):
        for block in range(2):
            f = f"layer{stage}_{block}"
            t = f"{prefix}layer{stage}.{block}"
            _conv(out, f"{t}.conv1", params[f]["conv1"])
            _bn(out, f"{t}.bn1", params[f]["bn1"], _sub(stats, f, "bn1"))
            _conv(out, f"{t}.conv2", params[f]["conv2"])
            _bn(out, f"{t}.bn2", params[f]["bn2"], _sub(stats, f, "bn2"))
            if "downsample_conv" in params[f]:
                _conv(out, f"{t}.downsample.0", params[f]["downsample_conv"])
                _bn(out, f"{t}.downsample.1", params[f]["downsample_bn"],
                    _sub(stats, f, "downsample_bn"))
    if "fc" in params:
        _dense(out, f"{prefix}fc", params["fc"])


def _string_dense(out: dict, fmt: str, params: Mapping) -> None:
    kernel, bias = np.asarray(params["kernel"]), np.asarray(params["bias"])
    for i in range(kernel.shape[0]):  # stacked [6, in, out] -> per branch
        out[fmt.format(i=i) + ".weight"] = _t(kernel[i].T)
        out[fmt.format(i=i) + ".bias"] = _t(bias[i])


def _string_bn(out: dict, fmt: str, params: Mapping, stats: Mapping | None) -> None:
    for i in range(np.asarray(params["scale"]).shape[0]):
        _bn(out, fmt.format(i=i),
            {"scale": np.asarray(params["scale"])[i],
             "bias": np.asarray(params["bias"])[i]},
            None if stats is None else
            {"mean": np.asarray(stats["mean"])[i],
             "var": np.asarray(stats["var"])[i]})


def _guitartabnet(params: Mapping, stats: Mapping | None) -> dict[str, torch.Tensor]:
    out: dict[str, torch.Tensor] = {}
    _resnet(out, params["resnet"], _sub(stats, "resnet"), "resnet.")
    heads_p, heads_s = params["heads"], _sub(stats, "heads")
    _string_dense(out, "branches.{i}.0", heads_p["dense0"])
    _string_bn(out, "branches.{i}.2", heads_p["bn0"], _sub(heads_s, "bn0"))
    _string_dense(out, "branches.{i}.4", heads_p["dense1"])
    _string_bn(out, "branches.{i}.6", heads_p["bn1"], _sub(heads_s, "bn1"))
    _string_dense(out, "branches.{i}.8", heads_p["out"])
    return out


def _vit(out: dict, params: Mapping, stats: Mapping | None, prefix: str) -> None:
    """ViTBackbone -> Hugging Face ``ViTModel`` names (``vit_state_dict``)."""
    emb = f"{prefix}embeddings"
    if "patch_embed" in params:
        _conv(out, f"{emb}.patch_embeddings.projection", params["patch_embed"])
    else:  # the conv stem: the port's own names
        i = 0
        while f"stem_conv{i}" in params:
            _conv(out, f"{prefix}stem_conv{i}", params[f"stem_conv{i}"])
            _bn(out, f"{prefix}stem_bn{i}", params[f"stem_bn{i}"],
                _sub(stats, f"stem_bn{i}"))
            i += 1
        _conv(out, f"{prefix}stem_proj", params["stem_proj"])
    out[f"{emb}.cls_token"] = _t(params["cls_token"])
    out[f"{emb}.position_embeddings"] = _t(params["pos_embed"])
    _ln(out, f"{prefix}layernorm", params["ln_final"])
    layer = 0
    while f"block{layer}" in params:
        p = params[f"block{layer}"]
        t = f"{prefix}encoder.layer.{layer}"
        _ln(out, f"{t}.layernorm_before", p["ln_before"])
        _ln(out, f"{t}.layernorm_after", p["ln_after"])
        qkv_w, qkv_b = np.asarray(p["qkv"]["kernel"]), np.asarray(p["qkv"]["bias"])
        d = qkv_w.shape[0]
        for j, name in enumerate(("query", "key", "value")):
            _dense(out, f"{t}.attention.attention.{name}",
                   {"kernel": qkv_w[:, j * d:(j + 1) * d], "bias": qkv_b[j * d:(j + 1) * d]})
        _dense(out, f"{t}.attention.output.dense", p["proj"])
        _dense(out, f"{t}.intermediate.dense", p["mlp_in"])
        _dense(out, f"{t}.output.dense", p["mlp_out"])
        layer += 1


def _vittab(params: Mapping, stats: Mapping | None) -> dict[str, torch.Tensor]:
    out: dict[str, torch.Tensor] = {}
    # only a conv stem has backbone statistics
    vit_stats = None if stats is None else stats.get("vit")
    _vit(out, params["vit"], vit_stats, "vit.")
    _dense(out, "fc1", params["fc1"])
    _bn(out, "bn_fc1", params["bn_fc1"], _sub(stats, "bn_fc1"))
    _dense(out, "fc2", params["fc2"])
    _bn(out, "bn_fc2", params["bn_fc2"], _sub(stats, "bn_fc2"))
    _string_dense(out, "string_heads.{i}.1", params["heads"]["out"])
    return out


def _small_cnn(params: Mapping) -> dict[str, torch.Tensor]:
    """SmallTabCNN: the Flax names, conv kernels HWIO -> OIHW, the stacked
    dense kernels [6, in, out] as they are."""
    out: dict[str, torch.Tensor] = {}
    for i in (1, 2, 3):
        _conv(out, f"conv{i}", params[f"conv{i}"])
    for name in ("dense0", "dense1", "out"):
        out[f"{name}.weight"] = _t(params[name]["kernel"])
        out[f"{name}.bias"] = _t(params[name]["bias"])
    return out


def _model(params: Mapping, stats: Mapping | None) -> dict[str, torch.Tensor]:
    if "conv1" in params:
        return _small_cnn(params)
    return (_vittab if "vit" in params else _guitartabnet)(params, stats)


def state_dict_from_flax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Flax GuitarTabNet or ViTTab variables (NumPy leaves) -> this
    package's state dict: ``resnet.*`` + ``branches.{i}.{0,2,4,6,8}.*``, or
    ``vit.*`` + ``fc1``/``bn_fc1``/``fc2``/``bn_fc2`` +
    ``string_heads.{i}.1.*``, or SmallTabCNN's (which has no BatchNorm:
    ``batch_stats`` may be absent) ``conv{1,2,3}``, ``dense0``, ``dense1``,
    ``out``."""
    return _model(variables["params"], variables.get("batch_stats"))


def _find_adam(state: Any) -> Any:
    """The ``ScaleByAdamState`` (the node with ``mu`` and ``nu``) inside an
    optax state: named tuples and tuples, walked depth first."""
    if hasattr(state, "mu") and hasattr(state, "nu"):
        return state
    if isinstance(state, tuple):
        for item in state:
            found = _find_adam(item)
            if found is not None:
                return found
    return None


def adam_state_from_optax(opt_state: Any) -> dict[str, Any]:
    """The Adam moments of an optax state (the JAX package's
    ``make_optimizer`` chain, NumPy or JAX leaves) keyed by this package's
    parameter names: ``{"count": int, "mu": {name: tensor}, "nu": {...}}``,
    the form :meth:`..train.engine.TrainState.load_adam_state` takes."""
    adam = _find_adam(opt_state)
    if adam is None:
        raise ValueError("no Adam state (mu, nu) in this optax state")
    as_np = lambda tree: {  # noqa: E731
        k: as_np(v) if isinstance(v, Mapping) else np.asarray(v)
        for k, v in tree.items()
    }
    return {
        "count": int(np.asarray(adam.count)),
        "mu": _model(as_np(adam.mu), None),
        "nu": _model(as_np(adam.nu), None),
    }


def strip_module_prefix(sd: Mapping[str, Any]) -> dict[str, Any]:
    """Drop DataParallel's 'module.' prefix (tablature_generator.py:563)."""
    return {
        (k[len("module."):] if k.startswith("module.") else k): v
        for k, v in sd.items()
    }


def load_torch_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """A reference ``.pt`` checkpoint's model weights: a raw state dict or
    the best-checkpoint dict of bestengine.py:985-995
    (``{'model_state_dict': ...}``), 'module.' prefix removed."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "model_state_dict" in ckpt:
        ckpt = ckpt["model_state_dict"]
    return strip_module_prefix(ckpt)
