"""Weights across the two packages, and reference ``.pt`` checkpoints.

:func:`state_dict_from_flax` maps the JAX package's GuitarTabNet variables
(a nested dict of NumPy arrays: ``{'params': ..., 'batch_stats': ...}``)
to this package's state dict.  It is the port's own copy of the mapping in
the JAX package's ``models/torch_export.py`` (``guitartabnet_state_dict``);
the port does not import that package.

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


def _dense(out: dict, name: str, params: Mapping) -> None:
    out[f"{name}.weight"] = _t(np.asarray(params["kernel"]).T)
    if "bias" in params:
        out[f"{name}.bias"] = _t(params["bias"])


def _bn(out: dict, name: str, params: Mapping, stats: Mapping) -> None:
    out[f"{name}.weight"] = _t(params["scale"])
    out[f"{name}.bias"] = _t(params["bias"])
    out[f"{name}.running_mean"] = _t(stats["mean"])
    out[f"{name}.running_var"] = _t(stats["var"])
    out[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _resnet(out: dict, params: Mapping, stats: Mapping, prefix: str) -> None:
    _conv(out, f"{prefix}conv1", params["conv1"])
    _bn(out, f"{prefix}bn1", params["bn1"], stats["bn1"])
    for stage in range(1, 5):
        for block in range(2):
            f = f"layer{stage}_{block}"
            t = f"{prefix}layer{stage}.{block}"
            _conv(out, f"{t}.conv1", params[f]["conv1"])
            _bn(out, f"{t}.bn1", params[f]["bn1"], stats[f]["bn1"])
            _conv(out, f"{t}.conv2", params[f]["conv2"])
            _bn(out, f"{t}.bn2", params[f]["bn2"], stats[f]["bn2"])
            if "downsample_conv" in params[f]:
                _conv(out, f"{t}.downsample.0", params[f]["downsample_conv"])
                _bn(out, f"{t}.downsample.1", params[f]["downsample_bn"],
                    stats[f]["downsample_bn"])
    if "fc" in params:
        _dense(out, f"{prefix}fc", params["fc"])


def _string_dense(out: dict, fmt: str, params: Mapping) -> None:
    kernel, bias = np.asarray(params["kernel"]), np.asarray(params["bias"])
    for i in range(kernel.shape[0]):  # stacked [6, in, out] -> per branch
        out[fmt.format(i=i) + ".weight"] = _t(kernel[i].T)
        out[fmt.format(i=i) + ".bias"] = _t(bias[i])


def _string_bn(out: dict, fmt: str, params: Mapping, stats: Mapping) -> None:
    for i in range(np.asarray(params["scale"]).shape[0]):
        _bn(out, fmt.format(i=i),
            {"scale": np.asarray(params["scale"])[i],
             "bias": np.asarray(params["bias"])[i]},
            {"mean": np.asarray(stats["mean"])[i],
             "var": np.asarray(stats["var"])[i]})


def state_dict_from_flax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Flax GuitarTabNet variables (NumPy leaves) -> this package's
    GuitarTabNet state dict (``resnet.*`` + ``branches.{i}.{0,2,4,6,8}.*``)."""
    params, stats = variables["params"], variables["batch_stats"]
    out: dict[str, torch.Tensor] = {}
    _resnet(out, params["resnet"], stats["resnet"], "resnet.")
    heads_p, heads_s = params["heads"], stats["heads"]
    _string_dense(out, "branches.{i}.0", heads_p["dense0"])
    _string_bn(out, "branches.{i}.2", heads_p["bn0"], heads_s["bn0"])
    _string_dense(out, "branches.{i}.4", heads_p["dense1"])
    _string_bn(out, "branches.{i}.6", heads_p["bn1"], heads_s["bn1"])
    _string_dense(out, "branches.{i}.8", heads_p["out"])
    return out


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
