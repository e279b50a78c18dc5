"""The port's host->device pipeline (``data/pipeline.py``) on the CPU, after
tests/test_pipeline.py:14-36: order and content, short streams,
``host_shard``'s slices and error; and the pinned-buffer reuse rule of the
card's path with stand-in events."""

import numpy as np
import pytest
import torch

from guitar_tablature_classification_tpu.data import device_prefetch as jax_prefetch
from guitar_tablature_classification_tpu.data import host_shard as jax_host_shard
from guitar_tablature_classification_tpu_torch.data import pipeline
from guitar_tablature_classification_tpu_torch.data.pipeline import (
    as_device_batches,
    device_prefetch,
    host_shard,
)


def test_device_prefetch_order_and_content():
    batches = [{"x": np.full((2, 3), i, np.float32), "y": np.arange(2) + i} for i in range(5)]
    out = list(device_prefetch(iter(batches), size=2, device="cpu"))
    want = list(jax_prefetch(iter(batches), size=2))
    assert len(out) == len(want) == 5
    for b, w in zip(out, want):
        assert isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu"
        for key in b:
            np.testing.assert_array_equal(b[key].numpy(), np.asarray(w[key]))


@pytest.mark.parametrize("size", [1, 4])
def test_device_prefetch_short_stream(size):
    batches = [{"x": np.zeros((1,))}]
    assert len(list(device_prefetch(iter(batches), size=size, device="cpu"))) == 1
    assert list(as_device_batches(iter([]), prefetch=size, device="cpu")) == []


def test_host_shard_matches_jax():
    batch = {"x": np.arange(8).reshape(8, 1), "y": np.arange(16).reshape(8, 2)}
    for pi in (0, 1):
        got = host_shard(batch, process_index=pi, process_count=2)
        want = jax_host_shard(batch, process_index=pi, process_count=2)
        for key in batch:
            np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(host_shard(batch, process_index=1, process_count=2)["x"][:, 0],
                                  [4, 5, 6, 7])
    # no process group: this process is the only one
    assert host_shard(batch)["x"] is batch["x"]
    with pytest.raises(ValueError, match="not divisible by process count 2"):
        host_shard({"x": np.zeros((7, 1))}, process_index=0, process_count=2)


def test_as_device_batches_names_the_mesh_item():
    """Under a mesh each rank gets its contiguous rows of every batch, on
    the mesh's device (here a mesh of two ranks planned without
    processes, seen from rank 1)."""
    from guitar_tablature_classification_tpu_torch.config import MeshConfig
    from guitar_tablature_classification_tpu_torch.parallel import make_mesh

    mesh = make_mesh(MeshConfig(), world_size=2, rank=1, device="cpu")
    batch = {"x": np.arange(8)[:, None] * np.ones((1, 3)), "y": np.arange(8)}
    out = list(as_device_batches(iter([batch, batch]), mesh=mesh))
    assert len(out) == 2
    np.testing.assert_array_equal(out[0]["y"].numpy(), [4, 5, 6, 7])
    np.testing.assert_array_equal(out[1]["x"].numpy(), batch["x"][4:])
    with pytest.raises(ValueError, match="not divisible by the data axis"):
        next(as_device_batches(iter([{"x": np.zeros(3)}]), mesh=mesh))


def test_prefetch_on_the_card_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(device_prefetch(iter([{"x": np.zeros(2)}])))


class _Event:
    def __init__(self):
        self.done = False
        self.waited = False

    def query(self):
        return self.done

    def synchronize(self):
        self.waited = self.done = True


def test_pinned_pool_reuses_a_set_only_after_its_copy():
    """As the prefetcher uses it (take a set, fill it, give it back behind
    its copy's event): a set comes back once its event has completed;
    while none has, new sets are made up to the limit, and past it the
    oldest copy is waited for (never a buffer whose copy may still read
    it)."""
    pool = pipeline._PinnedPool(limit=2)
    a, b = {"tag": "a"}, {"tag": "b"}
    ea, eb, ec = _Event(), _Event(), _Event()
    assert pool.take() == {}
    pool.give(a, ea)
    assert pool.take() == {}  # a's copy is in flight: a second set
    pool.give(b, eb)
    eb.done = True
    assert pool.take() is b  # b's copy is done, a's is not
    pool.give(b, ec)
    assert pool.take() is a and ea.waited and not ec.waited  # at the limit: the oldest
