"""LC-GAN Generator (cnn.py:46-115), PyTorch port of
``lcgan_tpu.models.generator``.

Module and parameter names mirror the Flax tree (``block_{i}``,
``skip_layer``, ``flow_layer``, ``modulated_conv{0,1}``, ``rgb_layer``,
``{geometry,appearance}_mapping``, ``const``), so the weight bridge
(``lcgan_torch.convert``) maps leaf to leaf by name.

Each SynthesisBlock (custom_layers.py:114-166) runs four branches: skip
(1×1 conv ×√.5 → nearest 2× → box filter), flow field (mod-conv up2 → box
filter → tanh), main (mod-conv up2 → box filter → lrelu×√2 → mod-conv →
lrelu → +skip), then the bicubic feature warp by coordinates + flow·scale.
Every warp goes through ``ops.warp.grid_sample_bicubic``: the plain version
on the CPU; on the card the general CUDA kernels, or the small-map ones
where the JAX generator would take its small-map Pallas kernels
(``warp_impl``, ``warp_pallas_min_res``; ``ops.warp.small_route``).
``warp_impl="none"`` skips the warp, as the JAX block does: the block
returns its features unwarped and launches no warp kernel.

``remat`` checkpoints every SynthesisBlock and the ToRGBBlock
(``lcgan_torch.utils.remat``), as the JAX generator wraps them in
``nn.remat`` (lcgan_tpu/models/generator.py:270-293); a block whose output
map is at most ``remat_save_max_res`` keeps its three modulated convs' raw
outputs ("g_conv_out") when ``remat_save_g_convs`` is set, and ToRGB never
does. The mapping nets, the w-avg update and the const run outside any
checkpoint. The modules are called through the checkpoint, not wrapped, so
the ``state_dict`` keys are the same either way. The recompute launches the
block's forward warp kernel again: ``BicubicWarp`` keeps its inputs, not its
output.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from lcgan_torch import parallel
from lcgan_torch.config import Config
from lcgan_torch.ops.equalized import EqualizedConv2d
from lcgan_torch.ops.filters import box_filter_3x3, leaky_relu, nearest_upsample_2x
from lcgan_torch.ops.grid_sample import identity_like_coordinates
from lcgan_torch.ops.mapping import MappingNetwork
from lcgan_torch.ops.modulated import SynthesisLayer
from lcgan_torch.ops.warp import grid_sample_bicubic, small_route
from lcgan_torch.utils.remat import checkpoint_block

SQRT2 = math.sqrt(2.0)
SQRT_HALF = math.sqrt(0.5)


class SynthesisBlock(nn.Module):
    """Flow-warping synthesis block (custom_layers.py:114-166)."""

    def __init__(
        self,
        in_features: int,
        features: int,
        g_latent_dim: int,
        a_latent_dim: int,
        max_flow_scale: float,
        resolution: int,  # output map size
        use_noise: bool = False,  # reaches the two main convs, never the flow layer
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
        warp_impl: str = "auto",
        warp_pallas_min_res: int = 128,
    ):
        super().__init__()
        self.max_flow_scale = max_flow_scale
        self.dtype = dtype
        self.warp_impl = warp_impl  # "none": no warp at all (the JAX package's diagnostic ablation)
        # the warp's route on the card, static per block (as the JAX block's)
        self.small_warp = small_route(warp_impl, warp_pallas_min_res, resolution, resolution, features, max_flow_scale)
        kw = dict(dtype=dtype, generator=generator)
        self.skip_layer = EqualizedConv2d(in_features, features, 1, no_bias=True, **kw)
        # the three modulated convs' raw outputs are the remat save policy's "g_conv_out"
        saved = dict(kw, remat_save=True)
        self.flow_layer = SynthesisLayer(in_features, 2, g_latent_dim, up=2, **saved)
        self.modulated_conv0 = SynthesisLayer(
            in_features, features, a_latent_dim, up=2, use_noise=use_noise, resolution=resolution, **saved
        )
        self.modulated_conv1 = SynthesisLayer(
            features, features, a_latent_dim, up=1, use_noise=use_noise, resolution=resolution, **saved
        )

    def forward(self, x: torch.Tensor, g_latent: torch.Tensor, a_latents: torch.Tensor) -> torch.Tensor:
        # a_latents: (B, 2, a_dim) — two appearance codes per block (cnn.py:110)
        skip = self.skip_layer(x) * SQRT_HALF
        skip = box_filter_3x3(nearest_upsample_2x(skip))

        flow = self.flow_layer(x, g_latent)
        flow = torch.tanh(box_filter_3x3(flow).float())  # (B, 2, H, W) fp32

        y = self.modulated_conv0(x, a_latents[:, 0])
        y = leaky_relu(box_filter_3x3(y), 0.2, SQRT2)
        y = self.modulated_conv1(y, a_latents[:, 1])
        y = leaky_relu(y, 0.2)
        y = skip + y
        if self.warp_impl == "none":  # the flow is computed and dropped, as the JAX block does
            return y.to(self.dtype)

        # feature warping (custom_layers.py:162-165), sample coordinates in fp32
        b, _, h, w = y.shape
        coords = identity_like_coordinates(b, h, w, device=y.device)
        correspondence = (coords + flow.permute(0, 2, 3, 1) * self.max_flow_scale).contiguous()
        warped = grid_sample_bicubic(y.contiguous(memory_format=torch.channels_last), correspondence, self.small_warp)
        return warped.to(self.dtype)


class ToRGBBlock(nn.Module):
    """mod-conv 3×3 → lrelu → mod-conv 1×1 to RGB (custom_layers.py:169-182)."""

    def __init__(
        self,
        in_features: int,
        features: int,
        a_latent_dim: int,
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.modulated_conv0 = SynthesisLayer(in_features, in_features, a_latent_dim, kernel_size=3, **kw)
        self.modulated_conv1 = SynthesisLayer(in_features, features, a_latent_dim, kernel_size=1, **kw)

    def forward(self, x: torch.Tensor, a_latents: torch.Tensor) -> torch.Tensor:
        x = leaky_relu(self.modulated_conv0(x, a_latents[:, 0]), 0.2)
        return self.modulated_conv1(x, a_latents[:, 1])


class Generator(nn.Module):
    """Dual-mapping flow-warp generator (cnn.py:46-115).

    ``w_psi`` semantics (cnn.py:94-101): w_psi <= 0 updates the running w
    averages, the ``avg_latent1/2`` buffers, in place, in training mode as
    the reference's registered buffers are; w_psi > 0 lerps the codes toward
    the averages (truncation at inference). Generation runs in eval mode,
    which keeps the buffers: the JAX package computes the update there too
    and discards it.
    """

    def __init__(
        self,
        img_resolution: int,
        geo_noise_dim: int = 64,
        app_noise_dim: int = 64,
        geo_latent_dim: int = 64,
        app_latent_dim: int = 512,
        max_flow_scale: float = 0.1,
        base_nf: Optional[int] = None,
        max_nf: int = 512,
        img_ch: int = 3,
        w_avg_beta: float = 0.998,
        use_noise: bool = False,  # the reference disables it everywhere (cnn.py:83,87)
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
        warp_impl: str = "auto",
        warp_pallas_min_res: int = 128,
        remat: bool = False,
        remat_save_g_convs: bool = False,
        remat_save_max_res: int = 1024,
    ):
        super().__init__()
        self.w_avg_beta = w_avg_beta
        self.remat = remat
        self.dtype = dtype
        self.num_blocks = int(math.log2(img_resolution)) - 2
        if base_nf is None:
            base_nf = 32 if img_resolution == 1024 else 64 if img_resolution == 512 else 128

        geometry_channels = [geo_noise_dim] + [geo_latent_dim] * 12
        appearance_channels = [app_noise_dim, app_latent_dim // 4, app_latent_dim // 2] + [app_latent_dim] * 10
        self.geometry_mapping = MappingNetwork(geometry_channels, generator=generator)
        self.appearance_mapping = MappingNetwork(appearance_channels, generator=generator)
        self.register_buffer("avg_latent1", torch.zeros(geo_latent_dim))
        self.register_buffer("avg_latent2", torch.zeros(app_latent_dim))
        self.const = nn.Parameter(torch.randn((max_nf, 4, 4), generator=generator))  # CHW (cnn.py:76)

        in_features = max_nf
        # per block under remat: keep the modulated convs' raw outputs (else plain remat)
        self.block_saves = [remat_save_g_convs and 8 * 2**i <= remat_save_max_res for i in range(self.num_blocks)]
        for i in range(self.num_blocks):
            features = min(base_nf * 2 ** (self.num_blocks - i - 1), max_nf)
            block = SynthesisBlock(
                in_features, features, geo_latent_dim, app_latent_dim, max_flow_scale,
                resolution=8 * 2**i, use_noise=use_noise, dtype=dtype, generator=generator,
                warp_impl=warp_impl, warp_pallas_min_res=warp_pallas_min_res,
            )
            self.add_module(f"block_{i}", block)
            in_features = features
        self.rgb_layer = ToRGBBlock(in_features, img_ch, app_latent_dim, dtype=dtype, generator=generator)

    def forward(
        self,
        rand_noise1: torch.Tensor,  # (B, geo_noise_dim)
        rand_noise2: torch.Tensor,  # (B, app_noise_dim)
        w_psi: float = -1.0,
        num_views: int = 1,
    ) -> torch.Tensor:
        """Returns (B, img_ch, H, W) images in the compute dtype.

        ``num_views > 1``: the batch is that many view-batches stacked along
        it (the view-batched train step's even G step, lcgan_tpu/train/steps.py:124-153).
        Everything is per-sample except the w-avg update, which replays one
        lerp per view in stacking order, as separate calls would
        (lcgan_tpu/models/generator.py:240-253)."""
        geometry_code = self.geometry_mapping(rand_noise1)
        appearance_code = self.appearance_mapping(rand_noise2)

        if w_psi <= 0:
            if self.training:
                # new_avg = mean(w).lerp(avg, beta) = m + beta * (avg - m)
                with torch.no_grad():
                    means = [code.reshape(num_views, -1, code.shape[-1]).mean(dim=1)
                             for code in (geometry_code, appearance_code)]  # (V, dim) each
                    # under data parallelism, the means over the global batch
                    # (the JAX generator's mean_axis pmean, generator.py:248-250):
                    # every view's in one call, the all-reduce being elementwise
                    parallel.mean_all_reduce(means)
                    for v in range(num_views):
                        for avg, m in zip((self.avg_latent1, self.avg_latent2), means):
                            avg.copy_(m[v] + self.w_avg_beta * (avg - m[v]))
        else:
            # avg.lerp(code, psi) = avg + psi * (code - avg)
            geometry_code = self.avg_latent1 + w_psi * (geometry_code - self.avg_latent1)
            appearance_code = self.avg_latent2 + w_psi * (appearance_code - self.avg_latent2)

        batch = rand_noise1.shape[0]
        x = self.const.to(self.dtype)[None].expand(batch, -1, -1, -1)
        x = x.contiguous(memory_format=torch.channels_last)
        a_pair = torch.stack([appearance_code, appearance_code], dim=1)  # (B, 2, a_dim)
        for i, save in enumerate(self.block_saves):
            block = getattr(self, f"block_{i}")
            args = (x, geometry_code, a_pair)
            x = checkpoint_block(block, *args, save_convs=save) if self.remat else block(*args)
        return checkpoint_block(self.rgb_layer, x, a_pair) if self.remat else self.rgb_layer(x, a_pair)


def build_generator(cfg: Config, generator: Optional[torch.Generator] = None) -> Generator:
    """The run's generator, on the CPU, drawn from ``generator``."""
    return Generator(
        img_resolution=cfg.img_resolution,
        geo_noise_dim=cfg.geo_noise_dim,
        app_noise_dim=cfg.app_noise_dim,
        geo_latent_dim=cfg.geo_latent_dim,
        app_latent_dim=cfg.app_latent_dim,
        max_flow_scale=cfg.max_flow_scale,
        base_nf=cfg.base_nf,
        max_nf=cfg.max_nf,
        img_ch=cfg.img_ch,
        dtype=cfg.dtype,
        generator=generator,
        warp_impl=cfg.warp_impl,
        warp_pallas_min_res=cfg.warp_pallas_min_res,
        remat=cfg.remat_blocks,
        remat_save_g_convs=cfg.remat_save_g_convs,
        remat_save_max_res=cfg.remat_save_max_res,
    )
