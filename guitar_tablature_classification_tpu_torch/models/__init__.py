"""GuitarTabNet (ResNet18 archs) and weight conversion."""

from .convert import (
    adam_state_from_optax,
    load_torch_checkpoint,
    state_dict_from_flax,
    strip_module_prefix,
)
from .heads import StringBranchHeads
from .resnet import BasicBlock, ResNet18
from .tabnet import GuitarTabNet, build_model

__all__ = [
    "adam_state_from_optax", "BasicBlock", "GuitarTabNet", "ResNet18", "StringBranchHeads",
    "build_model", "load_torch_checkpoint", "state_dict_from_flax",
    "strip_module_prefix",
]
