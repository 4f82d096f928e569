"""Dataset + distributed input pipeline (custom_dataset.py + worker.py:45-73),
PyTorch port of ``lcgan_tpu.data.dataset``.

Layout parity: images live under ``<dataset_path>/train/<class>/*`` (torch
ImageFolder, custom_dataset.py:51-54). Train mode yields the triple
(image, geometry_change, appearance_change) in [-1,1]; eval mode yields
(image, label) (custom_dataset.py:59-100).

Replacement for DistributedSampler + DataLoader:
  * per-epoch global shuffle from a seed, sharded per host process
    (``files[process_index::process_count]`` after the shuffle) — the exact
    DistributedSampler(shuffle=True, drop_last=True) partitioning semantics
  * a thread pool decodes/augments (PIL decode + cv2 warps release the GIL)
  * double-buffered prefetch so host work overlaps device steps

Deterministic given (seed, epoch) — an improvement over the reference's
worker-nondeterminism (SURVEY.md §5 "race detection"). The numpy draws are
the JAX package's, so both packages yield the same bytes; here a batch is a
dict of (B, 3, H, W) float32 torch tensors in [-1, 1], in pinned memory when
asked, and ``DeviceFeeder`` copies each to the card while the previous
iteration runs.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Tuple

import numpy as np
from PIL import Image
import torch

from lcgan_torch.data import augment
from lcgan_torch.utils import trace

_IMG_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp", ".ppm", ".tif", ".tiff"}


def _list_image_folder(root: str) -> Tuple[List[str], List[int]]:
    """ImageFolder scan: class subdirectories sorted, images sorted within."""
    classes = sorted(
        d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
    )
    files, labels = [], []
    if classes:
        for idx, cls in enumerate(classes):
            cdir = os.path.join(root, cls)
            for fn in sorted(os.listdir(cdir)):
                if os.path.splitext(fn)[1].lower() in _IMG_EXTS:
                    files.append(os.path.join(cdir, fn))
                    labels.append(idx)
    else:  # tolerate flat directories too
        for fn in sorted(os.listdir(root)):
            if os.path.splitext(fn)[1].lower() in _IMG_EXTS:
                files.append(os.path.join(root, fn))
                labels.append(0)
    if not files:
        raise FileNotFoundError(f"no images found under {root}")
    return files, labels


class ImageFolderDataset:
    """Decode → Lanczos square resize → (train) triple-view augmentation."""

    def __init__(self, data_dir: str, resized_size: int, is_train: bool, seed: int = 0):
        self.data_dir = data_dir
        self.resized_size = resized_size
        self.is_train = is_train
        self.seed = seed
        root = os.path.join(data_dir, "train")  # custom_dataset.py:52-53
        self.files, self.labels = _list_image_folder(root)

    def __len__(self) -> int:
        return len(self.files)

    def _load_resized(self, index: int) -> np.ndarray:
        img = Image.open(self.files[index]).convert("RGB")
        if img.size != (self.resized_size, self.resized_size):
            img = img.resize((self.resized_size, self.resized_size), Image.LANCZOS)
        return np.asarray(img, np.uint8)

    def get_train_uint8(self, index: int, rng: np.random.Generator):
        """(image, geometry_change, appearance_change), each uint8 — the
        pre-normalization triple (also the native loader's output form, so
        its per-sample fallback slots in directly)."""
        img = self._load_resized(index)
        if rng.random() < 0.5:  # shared random h-flip (custom_dataset.py:68)
            img = img[:, ::-1].copy()
        geo = augment.random_geometry_transform(img, rng)
        app = augment.random_appearance_transform(img, rng)
        return img, geo, app

    def get_train(self, index: int, rng: np.random.Generator):
        """(image, geometry_change, appearance_change), each float32 [-1,1]."""
        img, geo, app = self.get_train_uint8(index, rng)
        return (
            augment.to_model_range(img),
            augment.to_model_range(geo),
            augment.to_model_range(app),
        )

    def get_eval(self, index: int) -> Tuple[np.ndarray, int]:
        return augment.to_model_range(self._load_resized(index)), self.labels[index]


class TrainInputPipeline:
    """Sharded, shuffled, prefetching batch iterator over the triple views."""

    def __init__(
        self,
        dataset: ImageFolderDataset,
        batch_size: int,  # GLOBAL batch; this host yields its shard
        process_index: int = 0,
        process_count: int = 1,
        num_workers: int = 4,
        seed: int = 0,
        prefetch: int = 2,
        use_native: bool = True,
        pin_memory: bool = False,
    ):
        if batch_size % process_count:
            raise ValueError("global batch must divide evenly across hosts")
        self.dataset = dataset
        self.host_batch = batch_size // process_count
        self.process_index = process_index
        self.process_count = process_count
        self.seed = seed
        self.epoch = 0  # bumped on exhaustion (worker.py:114-125)
        self.pool = ThreadPoolExecutor(max_workers=max(1, num_workers))
        self.prefetch = prefetch
        self.pin_memory = pin_memory
        if use_native:
            from lcgan_torch import native

            use_native = native.available()
        self.use_native = use_native
        self._iter = self._make_iter()

    def _epoch_indices(self) -> np.ndarray:
        """DistributedSampler semantics: epoch-seeded global shuffle, strided
        shard per rank, drop_last at the batch level."""
        g = np.random.default_rng((self.seed, self.epoch))
        order = g.permutation(len(self.dataset))
        usable = (len(order) // self.process_count) * self.process_count
        return order[self.process_index:usable:self.process_count]

    def _make_batch(self, idxs: np.ndarray, epoch: int):
        if self.use_native:
            from lcgan_torch.native import load_batch

            paths = [self.dataset.files[int(i)] for i in idxs]
            seeds = [hash((self.seed, epoch, int(i))) for i in idxs]
            img, geo, app, failed = load_batch(
                paths, self.dataset.resized_size, seeds,
                num_threads=self.pool._max_workers,
            )
            if failed.any():
                # per-sample fallback: the C++ path decodes JPEG/PNG only —
                # one .bmp/.webp (or a transient IO error) must not abandon
                # the native path for the whole rest of training
                if not getattr(self, "_warned_native_fallback", False):
                    self._warned_native_fallback = True
                    print(
                        f"native loader: {int(failed.sum())} sample(s) fell "
                        f"back to the Python decoder (e.g. {paths[int(np.argmax(failed))]})"
                    )
                for j in np.nonzero(failed)[0]:
                    rng = np.random.default_rng((self.seed, epoch, int(idxs[j])))
                    img[j], geo[j], app[j] = self.dataset.get_train_uint8(int(idxs[j]), rng)
            return self._to_torch(
                {
                    "image": augment.to_model_range(img),
                    "geometry_change": augment.to_model_range(geo),
                    "appearance_change": augment.to_model_range(app),
                }
            )

        def one(i):
            rng = np.random.default_rng((self.seed, epoch, int(i)))
            return self.dataset.get_train(int(i), rng)

        triples = list(self.pool.map(one, idxs))
        imgs, geos, apps = zip(*triples)
        return self._to_torch(
            {
                "image": np.stack(imgs),
                "geometry_change": np.stack(geos),
                "appearance_change": np.stack(apps),
            }
        )

    def _to_torch(self, batch: dict) -> dict:
        """NHWC numpy → NCHW contiguous float32 tensors (pinned if asked)."""
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v.transpose(0, 3, 1, 2)))
            out[k] = t.pin_memory() if self.pin_memory else t
        return out

    def _make_iter(self) -> Iterator[dict]:
        while True:
            idxs = self._epoch_indices()
            nb = len(idxs) // self.host_batch  # drop_last=True
            if nb == 0:
                raise ValueError(
                    f"per-host batch {self.host_batch} exceeds shard size {len(idxs)}"
                )
            for b in range(nb):
                with trace.span("data.batch", device=False):  # on the thread that consumes this iterator
                    batch = self._make_batch(
                        idxs[b * self.host_batch : (b + 1) * self.host_batch], self.epoch
                    )
                yield batch
            self.epoch += 1

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        return next(self._iter)


class Prefetcher:
    """Depth-N background prefetch thread wrapping any iterator."""

    def __init__(self, it, depth: int = 2):
        self.it = it
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = object()
        self._error: Optional[BaseException] = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        try:
            for item in self.it:
                self.q.put(item)
        except BaseException as e:  # surfaced in __next__, not swallowed
            self._error = e
        finally:
            self.q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        if trace.recording():
            trace.count("data.get")
            trace.count("data.ready", int(not self.q.empty()))  # a batch was waiting: the pipeline kept ahead
        item = self.q.get()
        if item is self._done:
            if self._error is not None:
                # re-raise the loader's real failure (a corrupt file, a batch
                # geometry error) instead of a bare StopIteration that the
                # train loop would misread as end-of-data
                raise self._error
            raise StopIteration
        return item


class DeviceFeeder:
    """Yields the batches of ``it`` on ``device``. On a GPU each batch is
    copied on a side stream (``non_blocking``, from pinned memory) one step
    ahead, so the copy overlaps the iteration the current stream is running;
    the current stream waits for the copy before it uses the batch."""

    def __init__(self, it, device: torch.device):
        self.it = it
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self._next = self._stage()

    def _stage(self) -> dict:
        batch = next(self.it)
        if self.stream is None:
            return {k: v.to(self.device) for k, v in batch.items()}
        with torch.cuda.stream(self.stream):
            return {k: v.to(self.device, non_blocking=True) for k, v in batch.items()}

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        batch = self._next
        if self.stream is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_stream(self.stream)
            for v in batch.values():
                v.record_stream(current)  # the side stream's allocation is used on this one
        self._next = self._stage()
        return batch
