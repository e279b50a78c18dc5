"""Device-side DSP of the port: CQT (plain version + Hopper kernel),
framing, normalization, resize, smoothing."""

from .cqt import CQTFrontend, cqt_plain, reflect_index, split_geometry
from .cqt_kernels import CQTFilterbank, cqt_reference, make_filterbank, n_frames_for
from .framing import frame_track, num_windows, window_starts, window_times
from .normalize import db_to_unit, imagenet_normalize, tile_channels
from .resize import resize_bicubic, resize_matrix
from .smoothing import mode_filter, mode_filter_np

__all__ = [
    "CQTFilterbank", "CQTFrontend", "cqt_plain", "cqt_reference",
    "db_to_unit", "frame_track", "imagenet_normalize", "make_filterbank",
    "mode_filter", "mode_filter_np", "n_frames_for", "num_windows",
    "reflect_index", "resize_bicubic", "resize_matrix", "split_geometry",
    "tile_channels", "window_starts", "window_times",
]
