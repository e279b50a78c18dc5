"""Audio file loading, synthetic data, record packing, the loaders (feature
arrays, raw audio windows through the native C++ loader) and the
host->device pipeline."""

from .audio import load_audio, load_wav, resample
from .audio_loader import AudioWindowLoader, discover_tracks, load_label_grid
from .guitarset import (
    ArrayDataset,
    ArrayLoader,
    GuitarTabDataset,
    create_dataloaders,
    torch_random_split_indices,
)
from .packing import load_packed, pack_image_dir, pack_npy_dir
from .pipeline import as_device_batches, device_prefetch, host_shard
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
    "ArrayDataset", "ArrayLoader", "AudioWindowLoader", "GuitarTabDataset", "RenderConfig",
    "as_device_batches", "create_dataloaders", "device_prefetch", "discover_tracks",
    "events_to_jams_dict", "host_shard", "load_audio", "load_label_grid", "load_packed",
    "load_wav", "make_synthetic_dataset", "midi_to_hz", "pack_image_dir",
    "pack_npy_dir", "random_performance", "render_note", "render_performance",
    "resample", "torch_random_split_indices",
]
