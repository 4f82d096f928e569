"""Weight bridge between the JAX package's trees and the port's state.

Generator: Flax leaves are named ``block_{i}/{skip_layer,flow_layer,modulated_conv0,
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

Discriminator: the same rules (its convs, including the stride-2 ``conv1``,
are HWIO → OIHW, its linears (in, out) → (out, in)). Adam: the ``v`` tree
has its parameters' structure and takes their layouts; ``count`` is an int.
A whole JAX ``TrainState`` loads into the port's ``TrainState``
(``load_train_state``) and comes back as numpy trees
(``flax_from_train_state``); the PRNG key is not carried (the two
frameworks draw different numbers).

Every direction works on numpy arrays and is exact (permutes only). Orbax
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


def _to_torch(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    state = {}
    for path, value in flat.items():
        value = np.transpose(value, _layout(path, value.ndim))
        state[path.replace("/", ".")] = torch.tensor(value)  # a copy: JAX buffers are read-only
    return state


def _to_flax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    flat = {}
    for key, tensor in state_dict.items():
        path = key.replace(".", "/")
        value = tensor.detach().cpu().numpy()
        inverse = np.argsort(_layout(path, value.ndim))
        # copy(): a C-contiguous array that shares no memory with the module
        # (ascontiguousarray would alias contiguous leaves and turn 0-d into 1-d)
        flat[path] = np.transpose(value, inverse).copy()
    return flat


def generator_from_flax(params: dict, stats: dict) -> Dict[str, torch.Tensor]:
    """Flax (params, stats) trees → the port Generator's state_dict."""
    return _to_torch({**_flatten(params), **_flatten(stats)})


def flax_from_generator(state_dict: Dict[str, torch.Tensor]) -> Tuple[dict, dict]:
    """The port Generator's state_dict → Flax (params, stats) trees of numpy arrays."""
    params, stats = {}, {}
    for path, value in _to_flax(state_dict).items():
        (stats if path.rsplit("/", 1)[-1] in STATS else params)[path] = value
    return _unflatten(params), _unflatten(stats)


def discriminator_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """Flax params tree → the port Discriminator's state_dict."""
    return _to_torch(_flatten(params))


def flax_from_discriminator(state_dict: Dict[str, torch.Tensor]) -> dict:
    """The port Discriminator's state_dict → a Flax params tree of numpy arrays."""
    return _unflatten(_to_flax(state_dict))


def adam_from_flax(opt_state: dict) -> Tuple[Dict[str, torch.Tensor], int]:
    """The JAX mu-free Adam state {"v": tree, "count"} → (v by parameter name, count)."""
    return _to_torch(_flatten(opt_state["v"])), int(np.asarray(opt_state["count"]))


def flax_from_adam(v: Dict[str, torch.Tensor], count: int) -> dict:
    """(v by parameter name, count) → the JAX mu-free Adam state of numpy arrays."""
    return {"v": _unflatten(_to_flax(v)), "count": np.asarray(count, np.int32)}


def load_train_state(state, flax_state) -> None:
    """Load a JAX ``TrainState`` (leaves as numpy or JAX arrays) into the
    port's ``lcgan_torch.train.state.TrainState``, in place."""
    state.generator.load_state_dict(generator_from_flax(flax_state.g_params, flax_state.g_stats))
    state.ema.load_state_dict(generator_from_flax(flax_state.ema_params, flax_state.ema_stats))
    state.discriminator.load_state_dict(discriminator_from_flax(flax_state.d_params))
    for opt, tree in ((state.g_opt, flax_state.g_opt), (state.d_opt, flax_state.d_opt)):
        v, opt.count = adam_from_flax(tree)
        if v.keys() != opt.v.keys():
            raise KeyError(f"Adam v leaves differ: {sorted(v.keys() ^ opt.v.keys())}")
        for key, value in v.items():
            opt.v[key].copy_(value)
    state.step = int(np.asarray(flax_state.step))


def flax_from_train_state(state) -> dict:
    """The port's ``TrainState`` as the JAX ``TrainState``'s fields, numpy trees (no rng)."""
    g_params, g_stats = flax_from_generator(state.generator.state_dict())
    ema_params, ema_stats = flax_from_generator(state.ema.state_dict())
    return {
        "step": np.asarray(state.step, np.int32),
        "g_params": g_params,
        "g_stats": g_stats,
        "d_params": flax_from_discriminator(state.discriminator.state_dict()),
        "ema_params": ema_params,
        "ema_stats": ema_stats,
        "g_opt": flax_from_adam(state.g_opt.v, state.g_opt.count),
        "d_opt": flax_from_adam(state.d_opt.v, state.d_opt.count),
    }
