"""Weights of the FID Inception: pytorch-fid's checkpoint, or the ``.npz``
that ``lcgan_tpu.eval.convert.save_params_npz`` writes, into the port's
``InceptionV3FID`` (a copy of lcgan_tpu/eval/convert.py's rules; nothing of
that package is imported).

pytorch-fid's ``pt_inception-2015-12-05-6726825d.pth`` holds each
``BasicConv2d`` as ``<prefix>.conv.weight`` (OIHW) and a BatchNorm
``<prefix>.bn.{weight,bias,running_mean,running_var}``; the BatchNorm
(eps 1e-3) is folded into a per-channel scale and bias:

    scale = gamma / sqrt(running_var + eps)
    bias  = beta - running_mean * scale

The ``.npz`` holds the folded leaves under ``<top>/<branch>/{weight,
bn_scale,bn_bias}`` with HWIO weights, which take OIHW here. Both give the
module's ``state_dict`` (keys ``<prefix>.weight``, ``.bn_scale``,
``.bn_bias``); the classifier and AuxLogits are not used.
"""

from __future__ import annotations

import hashlib
from typing import Dict

import numpy as np
import torch

_BN_EPS = 1e-3

# torch.hub convention: the filename's -6726825d suffix is the first 8 hex
# chars of the file's SHA-256 (pt_inception-2015-12-05-6726825d.pth)
EXPECTED_SHA256_PREFIX = "6726825d"

_TOP_LEVEL = {
    "Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3", "Conv2d_3b_1x1", "Conv2d_4a_3x3",
    "Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c", "Mixed_6d",
    "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c",
}


def verify_checkpoint(pth_path: str) -> bool:
    """Check the .pth against the pinned reference fingerprint; warn when it
    differs."""
    h = hashlib.sha256()
    with open(pth_path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    ok = h.hexdigest().startswith(EXPECTED_SHA256_PREFIX)
    if not ok:
        print(
            f"WARNING: {pth_path}: sha256 {h.hexdigest()[:16]}… does not start with "
            f"{EXPECTED_SHA256_PREFIX} — not the reference pytorch-fid "
            "checkpoint; the resulting FID will not follow the reference protocol"
        )
    return ok


def _fold_basic_conv(sd: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """One BasicConv2d of pytorch-fid's state dict, its BatchNorm folded
    (in numpy, as the JAX converter folds it, so both give the same bits)."""
    gamma, beta, mean, var = (sd[f"{prefix}.bn.{k}"].numpy()
                              for k in ("weight", "bias", "running_mean", "running_var"))
    scale = gamma / np.sqrt(var + _BN_EPS)
    bias = beta - mean * scale
    return {
        f"{prefix}.weight": sd[f"{prefix}.conv.weight"].float().contiguous(),
        f"{prefix}.bn_scale": torch.from_numpy(scale.astype(np.float32)),
        f"{prefix}.bn_bias": torch.from_numpy(bias.astype(np.float32)),
    }


def state_dict_from_pth(pth_path: str) -> Dict[str, torch.Tensor]:
    """pytorch-fid's checkpoint → ``InceptionV3FID``'s state_dict (its
    fingerprint checked, with a warning if it is not the reference's)."""
    verify_checkpoint(pth_path)
    sd = torch.load(pth_path, map_location="cpu", weights_only=True)
    out: Dict[str, torch.Tensor] = {}
    for prefix in sorted({k.rsplit(".conv.", 1)[0] for k in sd if k.endswith(".conv.weight")}):
        if prefix.split(".")[0] in _TOP_LEVEL:  # fc / AuxLogits: not used for pool3 features
            out.update(_fold_basic_conv(sd, prefix))
    return out


def state_dict_from_npz(path: str) -> Dict[str, torch.Tensor]:
    """The JAX converter's ``.npz`` (folded, HWIO) → ``InceptionV3FID``'s state_dict."""
    out: Dict[str, torch.Tensor] = {}
    with np.load(path) as flat:
        for key in flat.files:
            value = flat[key]
            if key.endswith("/weight"):
                value = value.transpose(3, 2, 0, 1)  # HWIO → OIHW
            out[key.replace("/", ".")] = torch.from_numpy(np.ascontiguousarray(value, np.float32))
    return out


def load_weights(path: str) -> Dict[str, torch.Tensor]:
    """``--inception_weights``: a pytorch-fid ``.pth`` or the JAX converter's ``.npz``."""
    return state_dict_from_pth(path) if path.endswith(".pth") else state_dict_from_npz(path)
