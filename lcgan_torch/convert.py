"""Weight bridge between the Flax generator tree and the port's state_dict.

Flax leaves are named ``block_{i}/{skip_layer,flow_layer,modulated_conv0,
modulated_conv1}/{linear,modulated_conv}/{weight,bias}``, ``rgb_layer/…``,
``{geometry,appearance}_mapping/{diagonal_params,basis_params,mlp_{k}/…}``,
``const``; the stats collection holds ``avg_latent1/2`` (and ``noise_const``
where ``use_noise`` is on). The port's modules carry the same names, so a
leaf's state_dict key is its Flax path with ``.`` for ``/``. Layouts:

  * convs HWIO → OIHW; the up=2 layers (``flow_layer`` and
    ``modulated_conv0`` of each block) take the conv-transpose layout
    (I, O, kh, kw), unflipped;
  * linears (in, out) → (out, in);
  * ``const`` HWC → CHW;
  * every other leaf as it is.

Both directions work on numpy arrays and are exact (permutes only). Orbax
checkpoints are not read here: that needs JAX.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

STATS = {"avg_latent1", "avg_latent2", "noise_const"}
_UP2_CONV = re.compile(r"^block_\d+/(flow_layer|modulated_conv0)/modulated_conv/weight$")


def _layout(path: str, ndim: int) -> Tuple[int, ...]:
    """Axis order taking the Flax leaf at ``path`` to its torch layout."""
    if path == "const":
        return (2, 0, 1)
    if ndim == 4:
        return (2, 3, 0, 1) if _UP2_CONV.match(path) else (3, 2, 0, 1)
    if ndim == 2 and path.endswith("/weight"):
        return (1, 0)
    return tuple(range(ndim))


def _flatten(tree: dict, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if hasattr(value, "items"):  # dict or Flax FrozenDict
            flat.update(_flatten(value, path + "/"))
        else:
            flat[path] = np.asarray(value)
    return flat


def _unflatten(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def generator_from_flax(params: dict, stats: dict) -> Dict[str, torch.Tensor]:
    """Flax (params, stats) trees → the port Generator's state_dict."""
    state = {}
    for path, value in {**_flatten(params), **_flatten(stats)}.items():
        value = np.transpose(value, _layout(path, value.ndim))
        state[path.replace("/", ".")] = torch.tensor(value)  # a copy: JAX buffers are read-only
    return state


def flax_from_generator(state_dict: Dict[str, torch.Tensor]) -> Tuple[dict, dict]:
    """The port Generator's state_dict → Flax (params, stats) trees of numpy arrays."""
    params, stats = {}, {}
    for key, tensor in state_dict.items():
        path = key.replace(".", "/")
        value = tensor.detach().cpu().numpy()
        inverse = np.argsort(_layout(path, value.ndim))
        # copy(): a C-contiguous array that shares no memory with the module
        # (ascontiguousarray would alias contiguous leaves and turn 0-d into 1-d)
        value = np.transpose(value, inverse).copy()
        (stats if path.rsplit("/", 1)[-1] in STATS else params)[path] = value
    return _unflatten(params), _unflatten(stats)
