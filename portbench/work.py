"""The work a cell's model needs, counted on the benchmark's own reference
on the meta device (shapes only, nothing computed): the model FLOPs of one
unit of each kind (a training iteration of each variant, or a generated
batch) by ``torch.utils.flop_counter.FlopCounterMode``, with the warp's
16-tap FLOPs added, and the bytes the warp applications need at least.

Recompute is never counted: the reference keeps every activation.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import model, train

META = torch.device("meta")


def element_bytes(flags: dict) -> int:
    """Bytes of an element of the features the warp takes: the compute dtype's."""
    return {"bfloat16": 2, "float32": 4}[flags.get("compute_dtype", "bfloat16")]


def warp_work(name: str, b: int, c: int, h: int, es: int) -> Tuple[int, int]:
    """(bytes, FLOPs) of a warp kernel on a (b, c, h, h) map: each input
    (the features and the cotangent as they take them, the fp32 grid) read
    once, each output written once; 16 taps of one multiply-add per output
    value, two per tap for the grid's gradient (x and g)."""
    n_out = b * h * h
    if name == "warp_dgrid":
        return 2 * n_out * c * es + 2 * n_out * 8, 64 * c * n_out  # x, g, grid; dgrid
    return 2 * n_out * c * es + n_out * 8, 32 * c * n_out  # x (or g), grid; out (or dx)


def warps_work(warps: model.WarpLog, es: int) -> Tuple[int, int]:
    """(bytes, FLOPs) of the logged warp applications: the forward of each,
    and the grid's and the features' gradients of each differentiated one."""
    total_b = total_f = 0
    for b, c, h, differentiated in warps:
        for name in ("warp_fwd",) + (("warp_dgrid", "warp_dx") if differentiated else ()):
            nb, nf = warp_work(name, b, c, h, es)
            total_b, total_f = total_b + nb, total_f + nf
    return total_b, total_f


def _meta_params(spec: model.Spec, grad: bool) -> model.Params:
    return {name: torch.zeros(shape, device=META).requires_grad_(grad and name not in model.BUFFERS)
            for name, shape, _ in spec}


def train_units(sizes: model.Sizes, recipe: train.Recipe, batch: int, es: int) -> Dict[str, Dict[str, int]]:
    """{variant: {"flops", "warp_bytes", "warp_flops"}} of one training
    iteration of each variant."""
    out = {}
    for index in (0, 1, 3):  # even, odd with R1, odd
        st = train.State.start(_meta_params(model.generator_spec(sizes), True),
                               _meta_params(model.discriminator_spec(sizes), True))
        views = {k: torch.zeros((batch, sizes.img_ch, sizes.img_resolution, sizes.img_resolution), device=META)
                 for k in ("image", "geometry_change", "appearance_change")}
        noise = tuple(torch.zeros((batch, d), device=META)
                      for d in (sizes.geo_noise_dim, sizes.app_noise_dim) * 3)
        warps: model.WarpLog = []
        with FlopCounterMode(display=False) as counter:
            train.iteration(st, sizes, recipe, views, noise, index, warps=warps)
        wb, wf = warps_work(warps, es)
        out[train.variant(index)] = {"flops": counter.get_total_flops() + wf, "warp_bytes": wb, "warp_flops": wf}
    return out


def generate_unit(sizes: model.Sizes, batch: int, w_psi: float, es: int) -> Dict[str, int]:
    """{"flops", "warp_bytes", "warp_flops"} of one generated batch."""
    p = _meta_params(model.generator_spec(sizes), False)
    z1 = torch.zeros((batch, sizes.geo_noise_dim), device=META)
    z2 = torch.zeros((batch, sizes.app_noise_dim), device=META)
    warps: model.WarpLog = []
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model.generator(p, sizes, z1, z2, w_psi=w_psi, training=False, warps=warps)
    wb, wf = warps_work(warps, es)
    return {"flops": counter.get_total_flops() + wf, "warp_bytes": wb, "warp_flops": wf}
