"""GuitarTabNet (ResNet18 archs), ViTTab (ViT archs) and weight conversion."""

from .convert import (
    adam_state_from_optax,
    load_torch_checkpoint,
    state_dict_from_flax,
    strip_module_prefix,
)
from .heads import SimpleStringHeads, StringBranchHeads
from .resnet import BasicBlock, ResNet18
from .tabnet import GuitarTabNet, ViTTab, build_model
from .vit import EncoderBlock, ViTBackbone

__all__ = [
    "adam_state_from_optax", "BasicBlock", "EncoderBlock", "GuitarTabNet", "ResNet18",
    "SimpleStringHeads", "StringBranchHeads", "ViTBackbone", "ViTTab", "build_model",
    "load_torch_checkpoint", "state_dict_from_flax", "strip_module_prefix",
]
