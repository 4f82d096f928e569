"""The port's input pipeline against the JAX package's, on the CPU.

Both read one seeded folder of PNG and JPEG images (two classes, sizes other
than the model's, so every image is Lanczos-resized) and must yield the same
bytes: the same uint8 triples from the dataset, and batches whose float32
values are equal bit for bit, with the same shard and epoch order, on the
Python/cv2 path and on the native C++ path. The port's batches are NCHW
torch tensors, the JAX package's NHWC numpy arrays.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from lcgan_tpu import native as j_native
from lcgan_tpu.data.dataset import ImageFolderDataset as JaxDataset
from lcgan_tpu.data.dataset import TrainInputPipeline as JaxPipeline
from lcgan_torch import native
from lcgan_torch.data import augment
from lcgan_torch.data.dataset import DeviceFeeder, ImageFolderDataset, Prefetcher, TrainInputPipeline

SIZE = 32
KEYS = ("image", "geometry_change", "appearance_change")


@pytest.fixture
def image_dir(tmp_path):
    rng = np.random.default_rng(0)
    for cls in ("a", "b"):
        d = tmp_path / "train" / cls
        d.mkdir(parents=True)
        for i in range(5):
            img = Image.fromarray(rng.integers(0, 255, (40 + 3 * i, 48, 3), dtype=np.uint8))
            if i % 2:
                img.save(d / f"{i}.png")
            else:
                img.save(d / f"{i}.jpg", quality=90)
    return str(tmp_path)


def test_dataset_uint8_triples_match_jax(image_dir):
    ours, ref = ImageFolderDataset(image_dir, SIZE, is_train=True), JaxDataset(image_dir, SIZE, is_train=True)
    assert ours.files == ref.files and ours.labels == ref.labels and len(ours) == 10
    for i in range(len(ours)):
        got = ours.get_train_uint8(i, np.random.default_rng((3, 1, i)))
        want = ref.get_train_uint8(i, np.random.default_rng((3, 1, i)))
        for a, b in zip(got, want):
            assert a.dtype == np.uint8 and a.shape == (SIZE, SIZE, 3)
            assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("shard", [(0, 1), (1, 2)])
def test_pipeline_batches_match_jax(image_dir, use_native, shard):
    """Seven batches of 4 (global) cross three epochs of the 10-image folder
    (drop_last, a fresh shuffle per epoch)."""
    if use_native and not (native.available() and j_native.available()):
        pytest.skip("the native loader needs g++, libjpeg and libpng")
    index, count = shard
    kw = dict(batch_size=4, process_index=index, process_count=count, num_workers=2, seed=5, use_native=use_native)
    ours = TrainInputPipeline(ImageFolderDataset(image_dir, SIZE, is_train=True), **kw)
    ref = JaxPipeline(JaxDataset(image_dir, SIZE, is_train=True), **kw)
    assert ours.use_native == ref.use_native == use_native
    for _ in range(7):
        got, want = next(ours), next(ref)
        assert ours.epoch == ref.epoch
        for k in KEYS:
            t = got[k]
            assert t.dtype == torch.float32 and t.shape == (4 // count, 3, SIZE, SIZE) and t.is_contiguous()
            assert t.permute(0, 2, 3, 1).numpy().tobytes() == want[k].tobytes(), k
    assert ours.epoch == 3  # two batches an epoch on either shard: the seventh opens epoch 3


def test_native_loader_builds_into_the_build_directory():
    if not native.available():
        pytest.skip("the native loader needs g++, libjpeg and libpng")
    path = native._lib_path()
    assert "/lcgan_torch/_build/liblcgan_loader-" in path and path.endswith(".so")


def test_prefetcher_and_device_feeder_on_cpu(image_dir):
    pipe = TrainInputPipeline(ImageFolderDataset(image_dir, SIZE, is_train=True), batch_size=2, num_workers=1, seed=1)
    ref = TrainInputPipeline(ImageFolderDataset(image_dir, SIZE, is_train=True), batch_size=2, num_workers=1, seed=1)
    feeder = DeviceFeeder(Prefetcher(pipe, depth=2), torch.device("cpu"))
    for _ in range(3):
        got, want = next(feeder), next(ref)
        assert all(torch.equal(got[k], want[k]) and got[k].device.type == "cpu" for k in KEYS)


def test_prefetcher_surfaces_the_loader_error():
    def broken():
        yield 1
        raise OSError("corrupt file")

    it = Prefetcher(broken(), depth=1)
    assert next(it) == 1
    with pytest.raises(OSError, match="corrupt"):
        next(it)


def test_to_model_range():
    out = augment.to_model_range(np.array([0, 128, 255], np.uint8))
    np.testing.assert_allclose(out, [-1.0, 128 / 255 * 2 - 1, 1.0], atol=1e-7)
