"""FID InceptionV3 (reference: eval/inception.py:16-310), PyTorch port of
``lcgan_tpu.eval.inception``.

The FID protocol's *TF-FID* variant (pytorch-fid's
``pt_inception-2015-12-05``): torchvision's inception_v3 topology with its
three patches (eval/inception.py:166-310):
  * the average-pool branches of InceptionA, C and E use count_include_pad=False
  * Mixed_7c (FIDInceptionE_2) uses a MAX pool in its pool branch
  * the 1008-class head is not built: the output is pool3, 2048-d

Inference only, NCHW: each ``BasicConv2d`` is conv (no bias) → the folded
BatchNorm (eps 1e-3) as a per-channel ``scale·y + bias`` → relu, its
parameters ``weight`` (OIHW), ``bn_scale``, ``bn_bias`` under pytorch-fid's
module names (``Mixed_5b.branch1x1``...). Inputs are in [-1, 1]
(``normalize_input=False``, worker.py:382) and resized to 299² bilinearly
with align_corners=False and no antialias (eval/inception.py:146-150). The
convs run in fp32; ``eval.fid`` turns TF32 off around them, as the JAX
package runs them at ``Precision.HIGHEST``. Weights: ``eval.convert``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

Pair = Union[int, Tuple[int, int]]


def _pair(v: Pair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def avg_pool_cip_false(x: torch.Tensor) -> torch.Tensor:
    """3×3 average pool, stride 1, padding 1, count_include_pad=False (the TF-FID patch)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def max_pool(x: torch.Tensor, stride: int = 2, padding: int = 0) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=stride, padding=padding)


def resize_299(x: torch.Tensor) -> torch.Tensor:
    """Bilinear resize to 299², align_corners=False, no antialias, in fp32."""
    return F.interpolate(x.float(), size=(299, 299), mode="bilinear", align_corners=False, antialias=False)


class BasicConv2d(nn.Module):
    """conv (no bias) → folded-BN scale/bias → relu (lcgan_tpu/eval/inception.py:55-82)."""

    def __init__(self, cin: int, cout: int, kernel_size: Pair, stride: int = 1, padding: Pair = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.stride, self.padding = stride, _pair(padding)
        # random init, He-scaled truncated normal like the JAX module's
        # (its variance_scaling(2.0, "fan_in", "truncated_normal")); the FID
        # protocol loads pytorch-fid's weights over it
        std = math.sqrt(2.0 / (cin * kh * kw)) / 0.87962566103423978  # the std of N(0,1) cut at ±2
        w = torch.empty(cout, cin, kh, kw)
        nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
        self.weight = nn.Parameter(w)
        self.bn_scale = nn.Parameter(torch.ones(cout))
        self.bn_bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, self.weight, stride=self.stride, padding=self.padding)
        return F.relu(y * self.bn_scale[:, None, None] + self.bn_bias[:, None, None])


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.branch1x1 = BasicConv2d(cin, 64, 1, generator=g)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1, generator=g)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2, generator=g)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1, generator=g)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1, generator=g)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1, generator=g)
        self.branch_pool = BasicConv2d(cin, pool_features, 1, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(avg_pool_cip_false(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2, generator=g)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1, generator=g)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1, generator=g)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, max_pool(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, channels_7x7: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        g, c7 = generator, channels_7x7
        self.branch1x1 = BasicConv2d(cin, 192, 1, generator=g)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1, generator=g)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3), generator=g)
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0), generator=g)
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1, generator=g)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0), generator=g)
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3), generator=g)
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0), generator=g)
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3), generator=g)
        self.branch_pool = BasicConv2d(cin, 192, 1, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for layer in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = layer(bd)
        bp = self.branch_pool(avg_pool_cip_false(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.branch3x3_1 = BasicConv2d(cin, 192, 1, generator=g)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2, generator=g)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1, generator=g)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3), generator=g)
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0), generator=g)
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_4(self.branch7x7x3_3(self.branch7x7x3_2(self.branch7x7x3_1(x))))
        return torch.cat([b3, b7, max_pool(x)], dim=1)


class InceptionE(nn.Module):
    """``pool_mode`` "avg": FIDInceptionE_1 (Mixed_7b); "max": FIDInceptionE_2 (Mixed_7c)."""

    def __init__(self, cin: int, pool_mode: str = "avg", generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.pool_mode = pool_mode
        self.branch1x1 = BasicConv2d(cin, 320, 1, generator=g)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1, generator=g)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1), generator=g)
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0), generator=g)
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1, generator=g)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1, generator=g)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1), generator=g)
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0), generator=g)
        self.branch_pool = BasicConv2d(cin, 192, 1, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        bp = max_pool(x, stride=1, padding=1) if self.pool_mode == "max" else avg_pool_cip_false(x)
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], dim=1)


class InceptionV3FID(nn.Module):
    """pool3 (2048-d) features, fp32, of NCHW images in [-1, 1]."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2, generator=g)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3, generator=g)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1, generator=g)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1, generator=g)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3, generator=g)
        self.Mixed_5b = InceptionA(192, 32, generator=g)
        self.Mixed_5c = InceptionA(256, 64, generator=g)
        self.Mixed_5d = InceptionA(288, 64, generator=g)
        self.Mixed_6a = InceptionB(288, generator=g)
        self.Mixed_6b = InceptionC(768, 128, generator=g)
        self.Mixed_6c = InceptionC(768, 160, generator=g)
        self.Mixed_6d = InceptionC(768, 160, generator=g)
        self.Mixed_6e = InceptionC(768, 192, generator=g)
        self.Mixed_7a = InceptionD(768, generator=g)
        self.Mixed_7b = InceptionE(1280, "avg", generator=g)
        self.Mixed_7c = InceptionE(2048, "max", generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = resize_299(x) if x.shape[-2:] != (299, 299) else x.float()
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = max_pool(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = max_pool(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c", "Mixed_6d",
                     "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))  # adaptive average pool to 1×1
