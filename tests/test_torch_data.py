"""The port's input path against the reference's, on the CPU.

- ``imagenet_batches`` and ``file_batches`` give byte-identical batches
  to the reference's for the same seed, directory and arguments, and
  ``write_dataset`` / ``dataset_fields`` refuse what the reference's refuse;
- ``threaded_source`` keeps the order and runs the generator ahead by at
  most its capacity; ``device_prefetch`` keeps the order and places
  ``depth`` batches ahead of the consumer;
- ``to_device`` and ``KVStore.shard_batch`` take dicts, tuples and lists.
- ``device_prefetch`` places on the device of the runtime ``init`` made.
"""

import threading
import time

import numpy as np
import pytest
import torch

import ps_tpu_torch
from ps_tpu.data import files as ref_files
from ps_tpu.data.synthetic import imagenet_batches as ref_imagenet_batches
from ps_tpu_torch.data import files
from ps_tpu_torch.data.prefetch import device_prefetch, threaded_source
from ps_tpu_torch.data.synthetic import imagenet_batches
from ps_tpu_torch.kv.store import to_device


def _same(got, want):
    if isinstance(want, dict):
        assert list(got) == list(want)
        got, want = list(got.values()), list(want.values())
    assert type(got) is type(want) and len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("kw", [
    {"image_size": 16, "seed": 0}, {"image_size": 9, "seed": 7}])
def test_imagenet_batches_byte_identical(kw):
    got = list(imagenet_batches(3, steps=3, **kw))
    want = list(ref_imagenet_batches(3, steps=3, **kw))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _same(g, w)
    images, labels = got[0]
    assert images.shape == (3, kw["image_size"], kw["image_size"], 3)
    assert images.dtype == np.float32 and labels.dtype == np.int32


@pytest.fixture
def dataset(tmp_path):
    rng = np.random.default_rng(1)
    arrays = {"images": rng.normal(size=(23, 4, 4, 3)).astype(np.float32),
              "labels": rng.integers(0, 1000, 23).astype(np.int32),
              "weight": rng.random(23)}
    files.write_dataset(str(tmp_path / "port"), arrays)
    ref_files.write_dataset(str(tmp_path / "ref"), arrays)
    return tmp_path


@pytest.mark.parametrize("kw", [
    {},
    {"shuffle": True, "seed": 3},
    {"fields": ["labels", "images"], "as_tuple": ("images", "labels")},
    {"worker": 1, "num_workers": 2, "shuffle": True},
])
def test_file_batches_byte_identical(dataset, kw):
    for a, b in ((dataset / "port", dataset / "ref"),
                 (dataset / "ref", dataset / "port")):
        got = list(files.file_batches(str(a), 4, steps=9, **kw))
        want = list(ref_files.file_batches(str(b), 4, steps=9, **kw))
        assert len(got) == len(want) == 9  # rolls over epochs
        for g, w in zip(got, want):
            _same(g, w)


def test_files_refuse_what_the_reference_refuses(tmp_path, dataset):
    for mod in (files, ref_files):
        with pytest.raises(ValueError, match="disagree"):
            mod.write_dataset(str(tmp_path / "x"), {
                "a": np.zeros(3), "b": np.zeros(4)})
        with pytest.raises(ValueError, match="bad field"):
            mod.write_dataset(str(tmp_path / "x"), {"a/b": np.zeros(3)})
        with pytest.raises(FileNotFoundError):
            mod.dataset_fields(str(tmp_path / "missing"))
        with pytest.raises(KeyError, match="no fields"):
            next(mod.file_batches(str(dataset / "port"), 2, fields=["nope"]))
        with pytest.raises(ValueError, match="exceeds"):
            next(mod.file_batches(str(dataset / "port"), 24))
        with pytest.raises(ValueError, match="out of range"):
            next(mod.file_batches(str(dataset / "port"), 2, worker=2,
                                  num_workers=2))
    fields = files.dataset_fields(str(dataset / "port"))
    assert sorted(fields) == ["images", "labels", "weight"]
    assert isinstance(fields["images"], np.memmap)


def test_threaded_source_keeps_order_and_bounds_the_producer():
    made = []

    def gen():
        for i in range(8):
            made.append(i)
            yield i

    stream = threaded_source(gen(), capacity=2)
    assert next(stream) == 0
    deadline = time.monotonic() + 5
    while len(made) < 4 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.05)
    # one item consumed, two queued, one held by the blocked producer
    assert len(made) == 4
    assert list(stream) == list(range(1, 8))
    deadline = time.monotonic() + 5  # the producer ends with the stream
    while (any("(produce)" in t.name for t in threading.enumerate())
           and time.monotonic() < deadline):
        time.sleep(0.01)
    assert not any("(produce)" in t.name for t in threading.enumerate())


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_device_prefetch_keeps_order_and_depth(depth):
    placed = []

    def place(item):
        placed.append(item[1])
        return to_device(item, "cpu")

    source = ((np.full(3, i, np.float32), i) for i in range(6))
    out = []
    ps_tpu_torch.init(backend="cuda", device="cpu")
    try:
        for batch in device_prefetch(source, place=place, depth=depth):
            # when batch i is handed out, batches up to i + depth - 1 are
            # placed
            assert len(placed) == min(int(batch[1]) + depth, 6)
            assert isinstance(batch[0], torch.Tensor)
            out.append(int(batch[1]))
        with pytest.raises(ValueError, match="depth"):
            next(device_prefetch(iter([1]), depth=0))
    finally:
        ps_tpu_torch.shutdown()
    assert out == list(range(6))


def test_device_prefetch_defaults_to_the_runtime_device():
    ps_tpu_torch.init(backend="cuda", device="cpu")
    try:
        got = list(device_prefetch(iter([{"x": np.arange(3)}])))
    finally:
        ps_tpu_torch.shutdown()
    assert torch.equal(got[0]["x"], torch.arange(3))


def test_to_device_and_shard_batch_take_dicts_tuples_and_lists():
    images = np.ones((2, 4, 4, 3), np.float32)
    labels = np.arange(2, dtype=np.int32)
    for batch, non_blocking in (({"images": images, "labels": labels}, False),
                                ((images, labels), True),
                                ([images, labels], False)):
        got = to_device(batch, "cpu", non_blocking)
        assert type(got) is type(batch)
        leaves = list(got.values()) if isinstance(got, dict) else got
        assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
                   for t in leaves)
    ps_tpu_torch.init(backend="cuda", device="cpu")
    try:
        store = ps_tpu_torch.KVStore(optimizer="sgd")
        got = store.shard_batch((images, labels))
    finally:
        ps_tpu_torch.shutdown()
    assert isinstance(got, tuple) and got[1].dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), images)
