"""The plain reference of LC-GAN's generator and discriminator: float32
PyTorch operations on a dict of tensors, with no kernel of the port.

It follows the published model (rakutentech/lcgan, ``cnn.py`` and
``custom_layers.py``) in the algebraic form the port computes it:

* mapping nets: a learned factor ``orthogonalize(tanh(basis)) · diag(|d| +
  1e-6)`` (QR, sign-fixed so that diag(R) >= 0) on the noise, then an
  equalized MLP with no activations (lr_mul 0.01);
* synthesis blocks: skip (1×1 conv ×√½, nearest 2×, 3×3 box filter), flow
  (modulated transposed conv, box filter, tanh) and main (modulated
  transposed conv, box filter, lrelu·√2, modulated conv, lrelu) branches,
  then the features warped bicubically (``F.grid_sample``, zeros padding,
  align_corners False) at the reference's coordinate grid plus
  ``flow · max_flow_scale``;
* modulated convs as one shared-weight conv of the style-scaled input,
  demodulated after: ``conv(x·s, W)·rsqrt(Σ s²‖W‖² + 1e-8) + b``;
* the discriminator: a 1×1 ``from_rgb``, residual blocks (2×2 mean pool and
  1×1 skip ×√½; 3×3 conv, lrelu·√2, box filter, 3×3 stride-2 conv, lrelu),
  minibatch stddev over groups of 8 (group member g of slot m is sample
  g·(N/G) + m), a 3×3 conv, an equalized linear (lr_mul 0.01), the logit
  head and two L2-normalised projection heads on the 4×4 trunk features.

``Precision`` says how the tensors are rounded. ``FP32`` is the
reference: float32 throughout, TF32 off (the caller's ``reference_mode``).
``Precision.fp8()`` is the control of a cell's comparison: every tensor the
configuration holds in bfloat16 (the operands and outputs of the convs and
linears of the synthesis network and the discriminator, the filters,
activations and sums between them, the warp's features and output) is
rounded to fp8 (e4m3 values, e5m2 gradients, one scale a tensor), and the
products the configuration computes in float32 (the mapping nets, the
style affines) to bfloat16. ``Precision.bf16()`` rounds the first kind to
bfloat16, values and gradients: the configuration's own precision, a
witness of what its rounding does by itself. Accumulation stays float32.

Parameter names are the port's ``state_dict`` keys, so one dict of weights
loads into both.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

SQRT2 = math.sqrt(2.0)
SQRT_HALF = math.sqrt(0.5)
Params = Dict[str, torch.Tensor]


# ----------------------------------------------------------------------
# the configuration's sizes
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Sizes:
    img_resolution: int
    base_nf: int
    max_nf: int = 512
    img_ch: int = 3
    geo_noise_dim: int = 64
    app_noise_dim: int = 64
    geo_latent_dim: int = 64
    app_latent_dim: int = 512
    geo_projection_dim: int = 256
    app_projection_dim: int = 256
    max_flow_scale: float = 0.1
    mbstd_group_size: int = 8

    @property
    def num_blocks(self) -> int:
        return int(math.log2(self.img_resolution)) - 2

    @classmethod
    def of(cls, flags: dict) -> "Sizes":
        res = flags["img_resolution"]
        base = flags.get("base_nf") or (32 if res == 1024 else 64 if res == 512 else 128)
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in flags.items() if k in names and k != "base_nf"}, base_nf=base)


# ----------------------------------------------------------------------
# the parameters: (name, shape, init); init is ("randn", factor) or ("fill", value)
# ----------------------------------------------------------------------
Spec = List[Tuple[str, Tuple[int, ...], Tuple[str, float]]]


def _linear_spec(prefix: str, n_in: int, n_out: int, lr_mul: float, bias_init: float = 0.0) -> Spec:
    return [(f"{prefix}.weight", (n_out, n_in), ("randn", 1.0 / lr_mul)),
            (f"{prefix}.bias", (n_out,), ("fill", bias_init))]


def _mapping_spec(prefix: str, channels: List[int]) -> Spec:
    m = channels[0]
    spec = [(f"{prefix}.diagonal_params", (m,), ("randn", 1.0)), (f"{prefix}.basis_params", (m, m), ("randn", 1.0))]
    for i in range(len(channels) - 1):
        spec += _linear_spec(f"{prefix}.mlp_{i}", channels[i], channels[i + 1], 0.01)
    return spec


def _synthesis_layer_spec(prefix: str, n_in: int, n_out: int, latent: int, k: int, up: int) -> Spec:
    shape = (n_in, n_out, k, k) if up == 2 else (n_out, n_in, k, k)
    return _linear_spec(f"{prefix}.linear", latent, n_in, 1.0, bias_init=1.0) + [
        (f"{prefix}.modulated_conv.weight", shape, ("randn", 1.0)),
        (f"{prefix}.modulated_conv.bias", (n_out,), ("fill", 0.0))]


def g_block_features(s: Sizes) -> List[Tuple[int, int, int]]:
    """(in, out, output map size) of each synthesis block."""
    out, n_in = [], s.max_nf
    for i in range(s.num_blocks):
        f = min(s.base_nf * 2 ** (s.num_blocks - i - 1), s.max_nf)
        out.append((n_in, f, 8 * 2 ** i))
        n_in = f
    return out


def d_block_features(s: Sizes) -> List[Tuple[int, int]]:
    out, n_in = [], s.base_nf
    for i in range(s.num_blocks):
        f = min(s.base_nf * 2 ** (i + 1), s.max_nf)
        out.append((n_in, f))
        n_in = f
    return out


def generator_spec(s: Sizes) -> Spec:
    """The generator's parameters, then its two w-average buffers."""
    geo = [s.geo_noise_dim] + [s.geo_latent_dim] * 12
    app = [s.app_noise_dim, s.app_latent_dim // 4, s.app_latent_dim // 2] + [s.app_latent_dim] * 10
    spec = _mapping_spec("geometry_mapping", geo) + _mapping_spec("appearance_mapping", app)
    spec.append(("const", (s.max_nf, 4, 4), ("randn", 1.0)))
    for i, (n_in, f, _) in enumerate(g_block_features(s)):
        p = f"block_{i}"
        spec.append((f"{p}.skip_layer.weight", (f, n_in, 1, 1), ("randn", 1.0)))
        spec += _synthesis_layer_spec(f"{p}.flow_layer", n_in, 2, s.geo_latent_dim, 3, 2)
        spec += _synthesis_layer_spec(f"{p}.modulated_conv0", n_in, f, s.app_latent_dim, 3, 2)
        spec += _synthesis_layer_spec(f"{p}.modulated_conv1", f, f, s.app_latent_dim, 3, 1)
    c = g_block_features(s)[-1][1]
    spec += _synthesis_layer_spec("rgb_layer.modulated_conv0", c, c, s.app_latent_dim, 3, 1)
    spec += _synthesis_layer_spec("rgb_layer.modulated_conv1", c, s.img_ch, s.app_latent_dim, 1, 1)
    # the running w averages; a trained generator's are not zero
    spec += [("avg_latent1", (s.geo_latent_dim,), ("randn", 0.1)), ("avg_latent2", (s.app_latent_dim,), ("randn", 0.1))]
    return spec


def discriminator_spec(s: Sizes) -> Spec:
    spec = [("from_rgb.weight", (s.base_nf, s.img_ch, 1, 1), ("randn", 1.0)), ("from_rgb.bias", (s.base_nf,), ("fill", 0.0))]
    for i, (n_in, f) in enumerate(d_block_features(s)):
        p = f"block_{i}"
        spec += [(f"{p}.skip_layer.weight", (f, n_in, 1, 1), ("randn", 1.0)),
                 (f"{p}.conv0.weight", (n_in, n_in, 3, 3), ("randn", 1.0)), (f"{p}.conv0.bias", (n_in,), ("fill", 0.0)),
                 (f"{p}.conv1.weight", (f, n_in, 3, 3), ("randn", 1.0)), (f"{p}.conv1.bias", (f,), ("fill", 0.0))]
    c = d_block_features(s)[-1][1]
    spec += [("discriminator_epilogue.conv.weight", (c, c + 1, 3, 3), ("randn", 1.0)),
             ("discriminator_epilogue.conv.bias", (c,), ("fill", 0.0))]
    spec += _linear_spec("discriminator_epilogue.linear", c * 16, c, 0.01)
    spec += _linear_spec("logit_mapper.mlp_0", c, 1, 0.01)
    for head, dim in (("projection_header1", s.geo_projection_dim), ("projection_header2", s.app_projection_dim)):
        chans = [c * 16, c * 4, c, dim]
        for i in range(3):
            spec += _linear_spec(f"{head}.mlp_{i}", chans[i], chans[i + 1], 0.01)
    return spec


BUFFERS = ("avg_latent1", "avg_latent2")


def make_weights(specs: List[Spec], seed: int, device: torch.device) -> List[Params]:
    """Every leaf of each spec from ``seed``: one normal draw on ``device``
    for all the drawn leaves, cut into them in order; the filled leaves set.
    One dict a spec (the generator's and the discriminator's names overlap)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    drawn = sum(math.prod(shape) for spec in specs for _, shape, (kind, _) in spec if kind == "randn")
    flat = torch.randn(drawn, generator=gen, device=device)
    out, at = [], 0
    for spec in specs:
        params = {}
        for name, shape, (kind, value) in spec:
            if kind == "randn":
                n = math.prod(shape)
                params[name] = flat[at:at + n].view(shape).mul(value)
                at += n
            else:
                params[name] = torch.full(shape, value, device=device)
        out.append(params)
    return out


# ----------------------------------------------------------------------
# precision of the products
# ----------------------------------------------------------------------
_FINITE = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _quantize(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and back; fp8 with one scale a tensor onto
    its largest finite value."""
    if dtype is None:
        return x
    x = x.detach()
    if dtype in _FINITE:
        scale = x.abs().amax().float().clamp_min(1e-30) / _FINITE[dtype]
        return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)
    return x.to(dtype).to(x.dtype)


class _Round(torch.autograd.Function):
    """Rounds the value to ``fwd`` and the gradient to ``bwd``; the gradient's
    own rounding is differentiable again (straight through), for R1."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return _quantize(x, fwd)

    @staticmethod
    def backward(ctx, g):
        return g + (_quantize(g, ctx.bwd) - g).detach(), None, None


@dataclasses.dataclass(frozen=True)
class Precision:
    """How the reference's tensors are rounded: ``low`` (value, gradient)
    dtypes for what the configuration holds in bfloat16 (every conv's and
    linear's operands and output in the synthesis network and the
    discriminator, the filters, activations and sums between them, the
    features the warp samples and its output), ``high`` for the products it
    computes in float32 (the mapping nets, the style affines). None: float32."""

    low: Optional[Tuple[torch.dtype, torch.dtype]] = None
    high: Optional[Tuple[torch.dtype, torch.dtype]] = None

    @classmethod
    def fp8(cls) -> "Precision":
        """The control: fp8 where the configuration holds bfloat16 (e4m3
        values, e5m2 gradients, as fp8 training feeds them), bfloat16 where it
        computes in float32."""
        return cls(low=(torch.float8_e4m3fn, torch.float8_e5m2), high=(torch.bfloat16, torch.bfloat16))

    @classmethod
    def bf16(cls) -> "Precision":
        """The configuration's own precision: a witness of what its rounding
        does by itself."""
        return cls(low=(torch.bfloat16, torch.bfloat16))

    def round(self, x: torch.Tensor, level: str = "low") -> torch.Tensor:
        dtypes = self.low if level == "low" else self.high
        if dtypes is None:
            return x
        return _Round.apply(x, *dtypes)


FP32 = Precision()


@contextlib.contextmanager
def reference_mode() -> Iterator[None]:
    """float32 products without TF32, and nondeterministic kernels allowed
    (``grid_sample``'s backward has no deterministic CUDA kernel)."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
              torch.are_deterministic_algorithms_enabled())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(False)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before[:2]
        torch.use_deterministic_algorithms(before[2])


# ----------------------------------------------------------------------
# layers
# ----------------------------------------------------------------------
def linear(p: Params, name: str, x: torch.Tensor, lr_mul: float, prec: Precision, level: str) -> torch.Tensor:
    w = p[f"{name}.weight"]
    w = w * (lr_mul / math.sqrt(w.shape[1]))
    return prec.round(F.linear(prec.round(x, level), prec.round(w, level)) + p[f"{name}.bias"] * lr_mul, level)


def conv(p: Params, name: str, x: torch.Tensor, prec: Precision, stride: int = 1) -> torch.Tensor:
    w = p[f"{name}.weight"]
    k = w.shape[-1]
    w = w / math.sqrt(w.shape[1] * k * k)
    y = F.conv2d(prec.round(x), prec.round(w), stride=stride, padding=k // 2)
    bias = p.get(f"{name}.bias")
    return prec.round(y if bias is None else y + bias[None, :, None, None])


def box_filter(x: torch.Tensor) -> torch.Tensor:
    """3×3 mean, zero padding, divisor 9."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


def lrelu(x: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
    y = F.leaky_relu(x, 0.2)
    return y * gain if gain != 1.0 else y


def synthesis_layer(p: Params, name: str, x: torch.Tensor, latent: torch.Tensor, up: int,
                    prec: Precision) -> torch.Tensor:
    styles = linear(p, f"{name}.linear", latent, 1.0, prec, "high")
    w = p[f"{name}.modulated_conv.weight"]
    k = w.shape[-1]
    fan_in = (w.shape[0] if up == 2 else w.shape[1]) * k * k
    w = w / math.sqrt(fan_in)
    wsq = w.square().sum(dim=(2, 3))  # (I, O) for up=2, (O, I) otherwise
    if up == 1:
        wsq = wsq.t()
    demod = torch.rsqrt(styles.square() @ wsq + 1e-8)  # (B, O)
    xs = prec.round(x * styles[:, :, None, None])
    if up == 2:
        y = F.conv_transpose2d(xs, prec.round(w), stride=2, padding=(k - 1) // 2, output_padding=1)
    else:
        y = F.conv2d(xs, prec.round(w), padding=(k - 1) // 2)
    return prec.round(y * demod[:, :, None, None] + p[f"{name}.modulated_conv.bias"][None, :, None, None])


def orthogonalize(m: torch.Tensor) -> torch.Tensor:
    q, r = torch.linalg.qr(m)
    sign = torch.sign(torch.diagonal(r))
    return q * torch.where(sign == 0, torch.ones_like(sign), sign)[None, :]


def mapping(p: Params, name: str, z: torch.Tensor, prec: Precision) -> torch.Tensor:
    d = p[f"{name}.diagonal_params"].abs() + 1e-6
    factor = orthogonalize(torch.tanh(p[f"{name}.basis_params"])) * d[None, :]
    x = prec.round(prec.round(z, "high") @ prec.round(factor, "high").t(), "high")
    i = 0
    while f"{name}.mlp_{i}.weight" in p:
        x = linear(p, f"{name}.mlp_{i}", x, 0.01, prec, "high")
        i += 1
    return x


def coordinates(b: int, h: int, w: int, device) -> torch.Tensor:
    """The reference's sampling grid (custom_layers.py:127-134): normalised
    by size − 1, sampled with align_corners False, (x, y) order."""
    ys = 2.0 * torch.arange(h, dtype=torch.float32, device=device) / (h - 1) - 1.0
    xs = 2.0 * torch.arange(w, dtype=torch.float32, device=device) / (w - 1) - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)[None].expand(b, h, w, 2)


WarpLog = List[Tuple[int, int, int, bool]]  # (batch, channels, map side, differentiated) of each warp


def update_averages(p: Params, geo: torch.Tensor, app: torch.Tensor) -> None:
    """The running w averages, β 0.998, toward this batch's mean codes."""
    with torch.no_grad():
        for avg, code in ((p["avg_latent1"], geo), (p["avg_latent2"], app)):
            m = code.mean(dim=0)
            avg.copy_(m + 0.998 * (avg - m))


def generator(p: Params, s: Sizes, z1: torch.Tensor, z2: torch.Tensor, *, w_psi: float = -1.0,
              training: bool = True, prec: Precision = FP32, warps: Optional[WarpLog] = None,
              update_avg: bool = True) -> torch.Tensor:
    """Images (B, img_ch, H, W). In training with ``w_psi <= 0`` the w
    averages in ``p`` are updated in place (unless ``update_avg`` is off:
    the caller updates them from the whole batch); ``w_psi > 0`` pulls the
    codes toward them. ``warps`` collects each warp's shape."""
    geo = mapping(p, "geometry_mapping", z1, prec)
    app = mapping(p, "appearance_mapping", z2, prec)
    if w_psi <= 0:
        if training and update_avg:
            update_averages(p, geo, app)
    else:
        geo = p["avg_latent1"] + w_psi * (geo - p["avg_latent1"])
        app = p["avg_latent2"] + w_psi * (app - p["avg_latent2"])
    b = z1.shape[0]
    r = prec.round
    x = r(p["const"][None].expand(b, -1, -1, -1))
    for i, (_, _, res) in enumerate(g_block_features(s)):
        blk = f"block_{i}"
        skip = r(conv(p, f"{blk}.skip_layer", x, prec) * SQRT_HALF)
        skip = r(box_filter(F.interpolate(skip, scale_factor=2, mode="nearest")))
        flow = torch.tanh(r(box_filter(synthesis_layer(p, f"{blk}.flow_layer", x, geo, 2, prec))))
        y = synthesis_layer(p, f"{blk}.modulated_conv0", x, app, 2, prec)
        y = r(lrelu(r(box_filter(y)), SQRT2))
        y = r(lrelu(synthesis_layer(p, f"{blk}.modulated_conv1", y, app, 1, prec)))
        y = r(skip + y)
        grid = coordinates(b, res, res, y.device) + flow.permute(0, 2, 3, 1) * s.max_flow_scale
        if warps is not None:
            warps.append((b, y.shape[1], res, torch.is_grad_enabled() and y.requires_grad))
        x = r(F.grid_sample(y, grid, mode="bicubic", padding_mode="zeros", align_corners=False))
    x = r(lrelu(synthesis_layer(p, "rgb_layer.modulated_conv0", x, app, 1, prec)))
    return synthesis_layer(p, "rgb_layer.modulated_conv1", x, app, 1, prec)


def minibatch_stddev(x: torch.Tensor, group_size: int) -> torch.Tensor:
    n, c, h, w = x.shape
    g = min(group_size, n)
    y = x.reshape(g, n // g, 1, c, h, w)
    y = y - y.mean(dim=0, keepdim=True)
    y = (y.square().mean(dim=0) + 1e-8).sqrt()  # (N/G, 1, C, H, W)
    y = y.mean(dim=(2, 3, 4))  # (N/G, 1)
    y = y.repeat(g, 1).reshape(n, 1, 1, 1).expand(n, 1, h, w)
    return torch.cat([x, y], dim=1)


def _head(p: Params, name: str, x: torch.Tensor, layers: int, prec: Precision) -> torch.Tensor:
    for i in range(layers):
        x = linear(p, f"{name}.mlp_{i}", x, 0.01, prec, "low")
        if i < layers - 1:
            x = prec.round(F.leaky_relu(x, 0.2))
    return x


def discriminator(p: Params, s: Sizes, image: torch.Tensor, embeddings: bool = False,
                  prec: Precision = FP32) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(logit (B, 1), geometry and appearance embeddings or None)."""
    r = prec.round
    x = r(lrelu(conv(p, "from_rgb", image, prec)))
    for i in range(s.num_blocks):
        blk = f"block_{i}"
        skip = r(conv(p, f"{blk}.skip_layer", r(F.avg_pool2d(x, 2, stride=2)), prec) * SQRT_HALF)
        y = r(lrelu(conv(p, f"{blk}.conv0", x, prec), SQRT2))
        y = r(lrelu(conv(p, f"{blk}.conv1", r(box_filter(y)), prec, stride=2)))
        x = r(skip + y)
    e = r(minibatch_stddev(x, s.mbstd_group_size))
    e = r(lrelu(conv(p, "discriminator_epilogue.conv", e, prec)))
    e = r(lrelu(linear(p, "discriminator_epilogue.linear", e.flatten(1), 0.01, prec, "low")))
    logit = _head(p, "logit_mapper", e, 1, prec)
    if not embeddings:
        return logit, None, None
    flat = x.flatten(1)
    geo = r(F.normalize(_head(p, "projection_header1", flat, 3, prec), dim=-1))
    app = r(F.normalize(_head(p, "projection_header2", flat, 3, prec), dim=-1))
    return logit, geo, app
