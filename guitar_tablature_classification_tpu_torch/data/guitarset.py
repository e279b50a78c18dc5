"""GuitarSet dataset pairing, splits and loaders.

Reference-compatible surface (``GuitarTabDataset`` +
``create_dataloaders`` — my_dataloader.py:8-72, ViT_dataloader.py:8-88)
as the JAX package's ``data/guitarset.py`` implements it:
features/labels live in packed contiguous arrays (or are packed on first
use), items are served as whole batches of NumPy arrays, and the heavy
per-item math (dB normalize, bicubic resize, channel tile) happens on the
device inside the train step (:func:`..train.engine.make_preprocess`)
instead of in DataLoader worker processes.  The training loop
(:func:`..train.engine.train_model`) moves each batch to the state's
device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from ..config import DataConfig
from .packing import load_packed, pack_image_dir, pack_npy_dir


def torch_random_split_indices(
    n: int, ratios: tuple[float, float, float], seed: int = 42
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact ``torch.utils.data.random_split`` index semantics with a
    ``manual_seed(seed)`` generator (ViT_dataloader.py:68-71): lengths are
    floored with the remainder going to the first split, and the
    permutation is torch's randperm for that seed."""
    n_train = int(ratios[0] * n)
    n_val = int(ratios[1] * n)
    n_test = n - n_train - n_val
    g = torch.Generator().manual_seed(seed)
    perm = torch.randperm(n, generator=g).numpy()
    return (
        perm[:n_train],
        perm[n_train : n_train + n_val],
        perm[n_train + n_val : n_train + n_val + n_test],
    )


def _maybe_pack(src_dir: str, cache_prefix: str):
    """Pack a directory of .npy features OR spectrogram images (the
    reference CNN path's cqt_images/*.png) into one mmap shard."""
    if not os.path.exists(f"{cache_prefix}.npy"):
        entries = os.listdir(src_dir)
        if any(f.endswith(".npy") for f in entries):
            pack_npy_dir(src_dir, cache_prefix)
        else:
            pack_image_dir(src_dir, cache_prefix)
    return load_packed(cache_prefix)


@dataclass
class ArrayDataset:
    """In-memory (features, labels) pair with the GuitarTabDataset item
    protocol — used for synthetic datasets and tests."""

    features: np.ndarray
    labels: np.ndarray

    def __len__(self) -> int:
        return len(self.features)

    def __getitem__(self, i: int):
        tab = np.asarray(self.labels[i])
        frets = np.argmax(tab, axis=-1) if tab.ndim == 2 else tab
        return np.asarray(self.features[i], np.float32), frets.astype(np.int32)


class GuitarTabDataset:
    """Paired (features, labels), sorted-name alignment with the count
    assert of my_dataloader.py:13."""

    def __init__(
        self,
        features_dir: str,
        labels_dir: str,
        *,
        cache_dir: str | None = None,
    ):
        cache_dir = cache_dir or os.path.join(
            os.path.dirname(os.path.abspath(labels_dir)), "_packed"
        )
        os.makedirs(cache_dir, exist_ok=True)
        self.features, self.feature_names = _maybe_pack(
            features_dir, os.path.join(cache_dir, "features")
        )
        self.labels, self.label_names = _maybe_pack(
            labels_dir, os.path.join(cache_dir, "labels")
        )
        assert len(self.features) == len(self.labels), (
            f"feature/label count mismatch: {len(self.features)} vs "
            f"{len(self.labels)}"
        )

    def __len__(self) -> int:
        return len(self.features)

    def __getitem__(self, i: int):
        feats = np.asarray(self.features[i], dtype=np.float32)
        tab = np.asarray(self.labels[i])
        frets = (
            np.argmax(tab, axis=-1) if tab.ndim == 2 else tab
        )  # one-hot rows -> class indices (my_dataloader.py:40-44)
        return feats, frets.astype(np.int32)


@dataclass
class ArrayLoader:
    """Batched loader over index subsets of a GuitarTabDataset.

    Yields dict batches {'features' [B,F,T] f32, 'labels' [B,6] i32,
    'weights' [B,6] f32}; the final short batch is zero-padded to the
    static batch size with weights 0 (every step sees one shape).
    """

    dataset: GuitarTabDataset
    indices: np.ndarray
    batch_size: int
    shuffle: bool = False
    seed: int = 0
    _epoch: int = 0

    def __len__(self) -> int:
        return -(-len(self.indices) // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        order = np.asarray(self.indices)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            order = rng.permutation(order)
            self._epoch += 1
        b = self.batch_size
        for lo in range(0, len(order), b):
            idx = order[lo : lo + b]
            feats = np.stack(
                [np.asarray(self.dataset.features[i], np.float32) for i in idx]
            )
            tabs = np.stack([np.asarray(self.dataset.labels[i]) for i in idx])
            frets = (
                np.argmax(tabs, axis=-1) if tabs.ndim == 3 else tabs
            ).astype(np.int32)
            weights = np.ones((len(idx), frets.shape[1]), np.float32)
            if len(idx) < b:  # pad to static shape
                pad = b - len(idx)
                feats = np.concatenate(
                    [feats, np.zeros((pad,) + feats.shape[1:], np.float32)]
                )
                frets = np.concatenate(
                    [frets, np.zeros((pad,) + frets.shape[1:], np.int32)]
                )
                weights = np.concatenate(
                    [weights, np.zeros((pad, frets.shape[1]), np.float32)]
                )
            yield {"features": feats, "labels": frets, "weights": weights}


def create_dataloaders(
    features_dir: str,
    labels_dir: str,
    batch_size: int = 32,
    train_ratio: float = 0.8,
    val_ratio: float = 0.1,
    *,
    config: DataConfig | None = None,
    cache_dir: str | None = None,
) -> tuple[ArrayLoader, ArrayLoader, ArrayLoader]:
    """Reference-compatible entry (my_dataloader.py:52-72): 80/10/10
    seeded split into (train, val, test) loaders."""
    cfg = config or DataConfig()
    dataset = GuitarTabDataset(features_dir, labels_dir, cache_dir=cache_dir)
    test_ratio = 1.0 - train_ratio - val_ratio
    tr, va, te = torch_random_split_indices(
        len(dataset), (train_ratio, val_ratio, test_ratio), cfg.split_seed
    )
    make = lambda idx, shuffle: ArrayLoader(  # noqa: E731
        dataset, idx, batch_size, shuffle=shuffle, seed=cfg.shuffle_seed
    )
    return make(tr, True), make(va, False), make(te, False)
