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
are HWIO → OIHW, its linears (in, out) → (out, in)). Adam: with beta1 == 0
the JAX package's mu-free state ``{"v": tree, "count"}``, otherwise optax's
``(ScaleByAdamState(count, mu, nu), EmptyState())`` (``nu`` is the port's
``v``); the moment trees have their parameters' structure and take their
layouts, ``count`` is an int. The layout follows the port optimizer's type.
A whole JAX ``TrainState`` loads into the port's ``TrainState``
(``load_train_state``) and comes back as numpy trees
(``flax_from_train_state``); the PRNG key is not carried (the two
frameworks draw different numbers).

Every direction works on numpy arrays and is exact (permutes only). Orbax
checkpoints are not read here: that needs JAX.
"""

from __future__ import annotations

import re
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from lcgan_torch.train.state import Adam

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


class ScaleByAdamState(NamedTuple):
    """optax's Adam state, field for field (as numpy trees)."""

    count: np.ndarray
    mu: dict
    nu: dict


class EmptyState(NamedTuple):
    """optax's state of ``scale_by_learning_rate``: nothing."""


def _copy_into(mine: Dict[str, torch.Tensor], flax_tree: dict, what: str) -> None:
    theirs = _to_torch(_flatten(flax_tree))
    if theirs.keys() != mine.keys():
        raise KeyError(f"Adam {what} leaves differ: {sorted(theirs.keys() ^ mine.keys())}")
    for key, value in theirs.items():
        mine[key].copy_(value)


def load_optimizer(opt, opt_state) -> None:
    """A JAX optimizer state into the port's optimizer ``opt``, in place:
    the mu-free ``{"v", "count"}`` into ``AdamNoMu``, optax's
    ``(ScaleByAdamState, EmptyState)`` into ``Adam``."""
    if isinstance(opt, Adam):
        adam = opt_state[0]
        _copy_into(opt.mu, adam.mu, "mu")
        _copy_into(opt.v, adam.nu, "v")
        opt.count = int(np.asarray(adam.count))
    else:
        _copy_into(opt.v, opt_state["v"], "v")
        opt.count = int(np.asarray(opt_state["count"]))


def flax_from_optimizer(opt):
    """The port's optimizer as the JAX package's state of the same layout, numpy trees."""
    count = np.asarray(opt.count, np.int32)
    if isinstance(opt, Adam):
        return ScaleByAdamState(count, _unflatten(_to_flax(opt.mu)), _unflatten(_to_flax(opt.v))), EmptyState()
    return {"v": _unflatten(_to_flax(opt.v)), "count": count}


def load_train_state(state, flax_state) -> None:
    """Load a JAX ``TrainState`` (leaves as numpy or JAX arrays) into the
    port's ``lcgan_torch.train.state.TrainState``, in place."""
    state.generator.load_state_dict(generator_from_flax(flax_state.g_params, flax_state.g_stats))
    state.ema.load_state_dict(generator_from_flax(flax_state.ema_params, flax_state.ema_stats))
    state.discriminator.load_state_dict(discriminator_from_flax(flax_state.d_params))
    load_optimizer(state.g_opt, flax_state.g_opt)
    load_optimizer(state.d_opt, flax_state.d_opt)
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
        "g_opt": flax_from_optimizer(state.g_opt),
        "d_opt": flax_from_optimizer(state.d_opt),
    }
