"""Record packing: thousands of tiny .npy files -> one mmap-able shard.

The reference pipeline stores one ~100-byte ``(6,19)`` label file and one
feature file *per 0.2 s segment* — 43,188 label files ship in
``tablatures/`` — and pays a filesystem round trip per item inside
DataLoader workers (my_dataloader.py:31-44).  Packing everything into a
single contiguous array + name index makes a full-epoch read one
sequential mmap scan instead of one file open per item (SURVEY §7 hard
part 5).  A copy of the JAX package's ``data/packing.py``.
"""

from __future__ import annotations

import json
import os

import numpy as np


def pack_npy_dir(
    src_dir: str, out_prefix: str, *, dtype=None
) -> tuple[str, str]:
    """Pack all .npy files (sorted by name — the pairing order of
    my_dataloader.py:10-13) into ``{out_prefix}.npy`` + ``.index.json``.

    Returns (data_path, index_path).
    """
    names = sorted(f for f in os.listdir(src_dir) if f.endswith(".npy"))
    if not names:
        raise ValueError(f"no .npy files in {src_dir}")
    first = np.load(os.path.join(src_dir, names[0]))
    shape = first.shape
    out_dtype = np.dtype(dtype) if dtype is not None else first.dtype
    data_path = f"{out_prefix}.npy"
    index_path = f"{out_prefix}.index.json"

    packed = np.lib.format.open_memmap(
        data_path, mode="w+", dtype=out_dtype, shape=(len(names),) + shape
    )
    for i, name in enumerate(names):
        arr = np.load(os.path.join(src_dir, name))
        if arr.shape != shape:
            raise ValueError(
                f"{name}: shape {arr.shape} != first shape {shape}"
            )
        packed[i] = arr.astype(out_dtype)
    packed.flush()
    with open(index_path, "w") as f:
        json.dump({"names": names, "shape": list(shape),
                   "dtype": str(out_dtype)}, f)
    return data_path, index_path


def pack_image_dir(
    src_dir: str,
    out_prefix: str,
    *,
    size: int | None = None,
    extensions: tuple[str, ...] = (".png", ".jpg", ".jpeg"),
) -> tuple[str, str]:
    """Pack a directory of spectrogram images (the reference CNN path's
    ``cqt_images/*.png``, my_dataloader.py:17-30) into one uint8 RGB shard.

    ``size`` resizes on ingest (PIL bicubic); omit it to keep the native
    resolution and resize on device instead.
    """
    from PIL import Image

    names = sorted(
        f for f in os.listdir(src_dir)
        if os.path.splitext(f)[1].lower() in extensions
    )
    if not names:
        raise ValueError(f"no image files in {src_dir}")
    first = Image.open(os.path.join(src_dir, names[0])).convert("RGB")
    shape = (size, size) if size else first.size[::-1]
    data_path = f"{out_prefix}.npy"
    index_path = f"{out_prefix}.index.json"
    packed = np.lib.format.open_memmap(
        data_path, mode="w+", dtype=np.uint8,
        shape=(len(names), shape[0], shape[1], 3),
    )
    for i, name in enumerate(names):
        img = Image.open(os.path.join(src_dir, name)).convert("RGB")
        if size:
            img = img.resize((size, size), Image.BICUBIC)
        elif img.size[::-1] != shape:
            raise ValueError(f"{name}: size {img.size} != first {shape[::-1]}")
        packed[i] = np.asarray(img)
    packed.flush()
    with open(index_path, "w") as f:
        json.dump(
            {"names": names, "shape": list(shape) + [3], "dtype": "uint8"}, f
        )
    return data_path, index_path


def load_packed(out_prefix: str, *, mmap: bool = True):
    """-> (array [N, ...] (mmap by default), list of names)."""
    data = np.load(f"{out_prefix}.npy", mmap_mode="r" if mmap else None)
    with open(f"{out_prefix}.index.json") as f:
        index = json.load(f)
    return data, index["names"]
