"""Audio file loading, synthetic data, record packing and the loaders."""

from .audio import load_audio, load_wav, resample
from .guitarset import (
    ArrayDataset,
    ArrayLoader,
    GuitarTabDataset,
    create_dataloaders,
    torch_random_split_indices,
)
from .packing import load_packed, pack_image_dir, pack_npy_dir
from .synthetic import (
    RenderConfig,
    events_to_jams_dict,
    make_synthetic_dataset,
    midi_to_hz,
    random_performance,
    render_note,
    render_performance,
)

__all__ = [
    "ArrayDataset", "ArrayLoader", "GuitarTabDataset", "RenderConfig",
    "create_dataloaders", "events_to_jams_dict", "load_audio", "load_packed",
    "load_wav", "make_synthetic_dataset", "midi_to_hz", "pack_image_dir",
    "pack_npy_dir", "random_performance", "render_note", "render_performance",
    "resample", "torch_random_split_indices",
]
