"""FID evaluation (worker.py:381-425, eval/fid.py:4-27), PyTorch port of
``lcgan_tpu.eval.fid``.

The protocol: up to 50k real (train-split) images, drawn without
replacement, against as many images of the EMA generator at ``w_psi``;
pool3 features of the TF-FID InceptionV3 in fp32 whatever
``--compute_dtype`` is, with TF32 off (the JAX package runs its convs at
``Precision.HIGHEST``); the Fréchet distance in fp64 through
``scipy.linalg.sqrtm``. Under data parallelism each rank takes its shard of
the reals and its own fakes, and the features are gathered across the
ranks before the means and covariances (the reference never gathers,
worker.py:390-418).
"""

from __future__ import annotations

import contextlib
import math
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Tuple

import numpy as np
import torch
from scipy import linalg

from lcgan_torch import parallel
from lcgan_torch.config import Config
from lcgan_torch.data.dataset import ImageFolderDataset, Prefetcher
from lcgan_torch.eval.convert import load_weights
from lcgan_torch.eval.inception import InceptionV3FID


def calc_fid(sample_mean, sample_cov, real_mean, real_cov, eps: float = 1e-6) -> float:
    """Fréchet distance ||m1-m2||² + Tr(C1 + C2 - 2·(C1 C2)^{1/2})."""
    cov_sqrt = linalg.sqrtm(sample_cov @ real_cov)
    if not np.isfinite(cov_sqrt).all():
        offset = np.eye(sample_cov.shape[0]) * eps
        cov_sqrt = linalg.sqrtm((sample_cov + offset) @ (real_cov + offset))
    if np.iscomplexobj(cov_sqrt):
        if not np.allclose(np.diagonal(cov_sqrt).imag, 0, atol=1e-3):
            raise ValueError(f"Imaginary component {np.max(np.abs(cov_sqrt.imag))}")
        cov_sqrt = cov_sqrt.real
    mean_diff = sample_mean - real_mean
    return float(
        mean_diff @ mean_diff
        + np.trace(sample_cov) + np.trace(real_cov) - 2 * np.trace(cov_sqrt)
    )


def fid_real_indices(
    dataset_len: int, num_batches: int, local_b: int, seed: int,
    process_index: int = 0, process_count: int = 1,
) -> np.ndarray:
    """This rank's real-image indices: a seeded permutation of the dataset,
    truncated to the batch geometry, without replacement."""
    take = num_batches * local_b * process_count
    if take > dataset_len:
        raise ValueError(
            f"FID batch geometry needs {take} unique reals but the dataset has {dataset_len}"
        )
    perm = np.random.default_rng(seed).permutation(dataset_len)[:take]
    return perm[process_index::process_count]


def load_inception(cfg: Config, device: torch.device) -> InceptionV3FID:
    """The FID Inception on ``device``, in eval mode: ``--inception_weights``
    (pytorch-fid's .pth or the JAX converter's .npz), else seeded random
    weights, with a warning."""
    model = InceptionV3FID(generator=torch.Generator().manual_seed(0))
    if cfg.inception_weights:
        model.load_state_dict(load_weights(cfg.inception_weights))
    else:
        print(
            "WARNING: --inception_weights not set; using RANDOM Inception weights. "
            "The resulting FID is not comparable to the reference protocol."
        )
    return model.to(device).eval()


@contextlib.contextmanager
def fp32_convs() -> Iterator[None]:
    """No TF32 in cuDNN convs and cuBLAS products for the block; the previous
    settings come back on exit."""
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def fake_latents(cfg: Config, num_batches: int, local_b: int, rank: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Rank ``rank``'s (z1, z2) per batch, drawn on the CPU from a
    ``torch.Generator`` seeded ``seed + 1 + rank`` (as the JAX package keys
    its draws, lcgan_tpu/eval/fid.py:152)."""
    rng = torch.Generator().manual_seed(cfg.seed + 1 + rank)
    return [(torch.randn((local_b, cfg.geo_noise_dim), generator=rng),
             torch.randn((local_b, cfg.app_noise_dim), generator=rng)) for _ in range(num_batches)]


@torch.inference_mode()
def fid_evaluate(cfg: Config, generator: torch.nn.Module, device: torch.device) -> float:
    """FID of ``generator`` (the EMA generator on ``device``, in eval mode)
    against the run's image folder. Every rank returns the same value."""
    inception = load_inception(cfg, device)

    def features(imgs: torch.Tensor) -> np.ndarray:
        with fp32_convs():
            return inception(imgs.to(device)).cpu().numpy()

    dataset = ImageFolderDataset(cfg.dataset_path, cfg.img_resolution, is_train=False, seed=cfg.seed)
    pi, pc = parallel.rank(), parallel.world_size()
    n = min(len(dataset), 50000)
    local_b = max(cfg.batch_size // pc, 1)
    num_batches = int(math.floor(n / cfg.batch_size)) if cfg.batch_size <= n else 1
    if cfg.batch_size > n:  # tiny dataset: shrink the batch, never duplicate
        local_b = max(n // pc, 1)

    # ---- real features: decoded on a thread pool, prefetched ahead of the card ----
    idxs = fid_real_indices(len(dataset), num_batches, local_b, cfg.seed, pi, pc)
    with ThreadPoolExecutor(max_workers=max(1, cfg.num_data_workers)) as pool:

        def real_batches():
            for b in range(num_batches):
                chunk = idxs[b * local_b : (b + 1) * local_b]
                imgs = np.stack(list(pool.map(lambda i: dataset.get_eval(int(i))[0], chunk)))
                yield torch.from_numpy(imgs).permute(0, 3, 1, 2)

        real = np.concatenate([features(imgs) for imgs in Prefetcher(real_batches(), depth=2)], 0)

    # ---- features of this rank's fakes ----
    gen = []
    for z1, z2 in fake_latents(cfg, num_batches, local_b, pi):
        gen.append(features(generator(z1.to(device), z2.to(device), w_psi=cfg.w_psi)))
    gen = np.concatenate(gen, 0)

    real = parallel.all_gather_rows(real.astype(np.float64))
    gen = parallel.all_gather_rows(gen.astype(np.float64))
    fid_value = calc_fid(gen.mean(0), np.cov(gen, rowvar=False), real.mean(0), np.cov(real, rowvar=False))
    if pi == 0:
        print("fid_value:", fid_value)
    return fid_value
