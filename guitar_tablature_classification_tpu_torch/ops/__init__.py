"""Device-side ops of the port: CQT (plain version + Hopper kernel) and the
batch feature extraction over it, attention (plain version + Hopper
kernels), framing, normalization, resize, smoothing."""

from .attention import attention_reference, fused_attention, resolve_attention

from .cqt import CQTFrontend, cqt_plain, reflect_index, split_geometry
from .cqt_kernels import CQTFilterbank, cqt_reference, make_filterbank, n_frames_for
from .extract import extract_windows, process_all_audio
from .framing import frame_track, num_windows, window_starts, window_times
from .normalize import (
    db_to_unit,
    imagenet_normalize,
    min_max_normalize,
    tile_channels,
    z_score_normalize,
)
from .resize import resize_bicubic, resize_matrix
from .smoothing import mode_filter, mode_filter_np, mode_filter_sequential

__all__ = [
    "attention_reference", "fused_attention", "resolve_attention", "CQTFilterbank", "CQTFrontend", "cqt_plain", "cqt_reference",
    "db_to_unit", "extract_windows", "frame_track", "imagenet_normalize", "make_filterbank",
    "min_max_normalize", "mode_filter", "mode_filter_np", "mode_filter_sequential",
    "n_frames_for", "num_windows", "process_all_audio",
    "reflect_index", "resize_bicubic", "resize_matrix", "split_geometry",
    "tile_channels", "window_starts", "window_times", "z_score_normalize",
]
