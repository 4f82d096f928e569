"""LC-GAN Discriminator (cnn.py:7-43), PyTorch port of
``lcgan_tpu.models.discriminator``.

  * 1×1 ``from_rgb`` conv + LeakyReLU, then N residual blocks
    ``block_{i}`` with channels min(base_nf·2^i, max_nf) → min(base_nf·2^(i+1),
    max_nf) (cnn.py:19-27);
  * ``discriminator_epilogue``: mbstd → 3×3 ``conv`` → lrelu → ``linear``
    (C·16 → C, lr_mul 0.01) → lrelu (custom_layers.py:220-234);
  * ``logit_mapper`` (ProjectionHead [C, 1]) and, on request, the two
    L2-normalized heads ``projection_header{1,2}`` over the flattened 4×4
    trunk features (cnn.py:29-31, 38-41).

Module and parameter names are the Flax tree's, so the weight bridge maps
leaf to leaf by name. Features are NCHW (channels_last in memory), so the
flatten before the linears is already the reference's (C, H, W) order.

freezeD (worker.py:127-131) freezes ``from_rgb`` and ``block_0`` …
``block_{n-1}``: see ``lcgan_torch.train.freeze``.

``remat`` checkpoints every DiscriminatorBlock (``lcgan_torch.utils.remat``)
as the JAX discriminator wraps them in ``nn.remat``
(lcgan_tpu/models/discriminator.py:140-154); a block whose input map is at
most ``remat_save_max_res`` keeps its ``conv0`` and ``conv1`` outputs
("d_conv_out", never the skip conv's) when ``remat_save_d_convs`` is set.
``from_rgb``, the epilogue (mbstd's per-view statistics) and the heads run
outside any checkpoint.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from lcgan_torch.config import Config
from lcgan_torch.ops.equalized import EqualizedConv2d, EqualizedLinear
from lcgan_torch.ops.filters import avg_pool_2x2, box_filter_3x3, leaky_relu
from lcgan_torch.ops.mapping import ProjectionHead
from lcgan_torch.ops.mbstd import minibatch_stddev
from lcgan_torch.utils.remat import checkpoint_block

SQRT2 = math.sqrt(2.0)
SQRT_HALF = math.sqrt(0.5)


class DiscriminatorBlock(nn.Module):
    """Residual downsampling block (custom_layers.py:185-217), skip=True form."""

    def __init__(
        self,
        in_features: int,
        features: int,
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.skip_layer = EqualizedConv2d(in_features, features, 1, no_bias=True, **kw)
        self.conv0 = EqualizedConv2d(in_features, in_features, 3, remat_save=True, **kw)
        self.conv1 = EqualizedConv2d(in_features, features, 3, stride=2, remat_save=True, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skip = self.skip_layer(avg_pool_2x2(x)) * SQRT_HALF
        y = leaky_relu(self.conv0(x), 0.2, SQRT2)
        y = leaky_relu(self.conv1(box_filter_3x3(y)), 0.2)
        return skip + y


class DiscriminatorEpilogue(nn.Module):
    """mbstd → conv 3×3 → lrelu → linear → lrelu (custom_layers.py:220-234)."""

    def __init__(
        self,
        features: int,
        mbstd_group_size: int = 8,
        resolution: int = 4,
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.mbstd_group_size = mbstd_group_size
        self.conv = EqualizedConv2d(features + 1, features, 3, dtype=dtype, generator=generator)
        self.linear = EqualizedLinear(
            features * resolution * resolution, features, lr_mul=0.01, dtype=dtype, generator=generator
        )

    def forward(self, x: torch.Tensor, num_views: int = 1) -> torch.Tensor:
        x = minibatch_stddev(x, group_size=self.mbstd_group_size, num_views=num_views)
        x = leaky_relu(self.conv(x), 0.2)
        return leaky_relu(self.linear(x.flatten(1)), 0.2)


class Discriminator(nn.Module):
    """Shared trunk + logit head + geometry/appearance projection heads."""

    def __init__(
        self,
        img_resolution: int,
        geo_projection_dim: int = 256,
        app_projection_dim: int = 256,
        base_nf: Optional[int] = None,
        max_nf: int = 512,
        img_ch: int = 3,
        mbstd_group_size: int = 8,
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
        remat: bool = False,
        remat_save_d_convs: bool = False,
        remat_save_max_res: int = 1024,
    ):
        super().__init__()
        self.dtype = dtype
        self.remat = remat
        self.num_blocks = int(math.log2(img_resolution)) - 2
        # per block under remat: keep conv0's and conv1's outputs (else plain remat)
        self.block_saves = [
            remat_save_d_convs and img_resolution // 2**i <= remat_save_max_res for i in range(self.num_blocks)
        ]
        if base_nf is None:
            base_nf = 32 if img_resolution == 1024 else 64 if img_resolution == 512 else 128
        kw = dict(dtype=dtype, generator=generator)
        self.from_rgb = EqualizedConv2d(img_ch, base_nf, 1, **kw)
        in_features = base_nf
        for i in range(self.num_blocks):
            features = min(base_nf * 2 ** (i + 1), max_nf)
            self.add_module(f"block_{i}", DiscriminatorBlock(in_features, features, **kw))
            in_features = features
        c = in_features
        self.discriminator_epilogue = DiscriminatorEpilogue(c, mbstd_group_size, **kw)
        self.logit_mapper = ProjectionHead([c, 1], **kw)
        self.projection_header1 = ProjectionHead([c * 16, c * 4, c, geo_projection_dim], **kw)
        self.projection_header2 = ProjectionHead([c * 16, c * 4, c, app_projection_dim], **kw)

    def forward(
        self, image: torch.Tensor, get_embedding_features: bool = False, num_views: int = 1
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
        """image (B, img_ch, H, W) → (logit (B, 1), geometry and appearance
        embeddings (B, dim) or None), in the compute dtype. ``num_views``:
        the image is that many view-batches stacked along the batch; only
        mbstd sees it, everything else is per-sample."""
        x = image.to(self.dtype).contiguous(memory_format=torch.channels_last)
        x = leaky_relu(self.from_rgb(x), 0.2)
        for i, save in enumerate(self.block_saves):
            block = getattr(self, f"block_{i}")
            x = checkpoint_block(block, x, save_convs=save) if self.remat else block(x)
        logit = self.logit_mapper(self.discriminator_epilogue(x, num_views))
        if not get_embedding_features:
            return logit, None, None
        flat = x.flatten(1)
        geo = _l2_normalize(self.projection_header1(flat))
        app = _l2_normalize(self.projection_header2(flat))
        return logit, geo, app


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """torch F.normalize(p=2, dim=1) semantics: x / max(||x||, eps), in fp32."""
    xf = x.float()
    return (xf / xf.norm(dim=-1, keepdim=True).clamp_min(eps)).to(x.dtype)


def build_discriminator(cfg: Config, generator: Optional[torch.Generator] = None) -> Discriminator:
    """The run's discriminator, on the CPU, drawn from ``generator``."""
    return Discriminator(
        img_resolution=cfg.img_resolution,
        geo_projection_dim=cfg.geo_projection_dim,
        app_projection_dim=cfg.app_projection_dim,
        base_nf=cfg.base_nf,
        max_nf=cfg.max_nf,
        img_ch=cfg.img_ch,
        mbstd_group_size=cfg.mbstd_group_size,
        dtype=cfg.dtype,
        generator=generator,
        remat=cfg.remat_blocks,
        remat_save_d_convs=cfg.remat_save_d_convs,
        remat_save_max_res=cfg.remat_save_max_res,
    )
