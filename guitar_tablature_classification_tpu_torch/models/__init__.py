"""GuitarTabNet (ResNet18 archs), ViTTab (ViT archs), SmallTabCNN and weight
conversion."""

from .convert import (
    adam_state_from_optax,
    load_torch_checkpoint,
    state_dict_from_flax,
    strip_module_prefix,
)
from .heads import SimpleStringHeads, StackedDense, StringBranchHeads
from .resnet import BasicBlock, ResNet18
from .small_cnn import SmallTabCNN
from .tabnet import GuitarTabNet, ViTTab, build_model
from .vit import EncoderBlock, ViTBackbone

__all__ = [
    "adam_state_from_optax", "BasicBlock", "EncoderBlock", "GuitarTabNet", "ResNet18",
    "SimpleStringHeads", "SmallTabCNN", "StackedDense", "StringBranchHeads", "ViTBackbone", "ViTTab", "build_model",
    "load_torch_checkpoint", "state_dict_from_flax", "strip_module_prefix",
]
