"""Parity of the port's generator ops (lcgan_torch.ops) with lcgan_tpu.ops.

The same numpy weights and inputs go through the Flax module and its torch
counterpart, in fp32 on the CPU. Flax layouts are NHWC / HWIO / (in, out);
the torch side gets them transposed as ``lcgan_torch.convert`` does.
Tolerance 1e-5 abs/rel throughout, the QR of the mapping nets included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcgan_tpu.ops import equalized as j_eq
from lcgan_tpu.ops import filters as j_f
from lcgan_tpu.ops import mapping as j_map
from lcgan_tpu.ops import modulated as j_mod
from lcgan_torch.ops import equalized as t_eq
from lcgan_torch.ops import filters as t_f
from lcgan_torch.ops import mapping as t_map
from lcgan_torch.ops import modulated as t_mod

TOL = dict(atol=1e-5, rtol=1e-5)


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(a), (0, 3, 1, 2))))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def oihw(w_hwio: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(w_hwio, (3, 2, 0, 1))))


def iohw(w_hwio: np.ndarray) -> torch.Tensor:
    """conv-transpose layout for up=2: (I, O, kh, kw), unflipped."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(w_hwio, (2, 3, 0, 1))))


def f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("lr_mul,bias_init", [(1.0, 0.0), (0.01, 1.0)])
def test_equalized_linear(lr_mul, bias_init, rng):
    x, w, b = f32(rng, 4, 12), f32(rng, 12, 6) / lr_mul, f32(rng, 6)
    ref = j_eq.EqualizedLinear(6, bias_init=bias_init, lr_mul=lr_mul).apply(
        {"params": {"weight": w, "bias": b}}, x
    )
    mod = t_eq.EqualizedLinear(12, 6, bias_init=bias_init, lr_mul=lr_mul)
    mod.load_state_dict({"weight": torch.from_numpy(w.T.copy()), "bias": torch.from_numpy(b)})
    np.testing.assert_allclose(mod(torch.from_numpy(x)).detach().numpy(), np.asarray(ref), **TOL)


def test_equalized_linear_init_bias():
    mod = t_eq.EqualizedLinear(8, 5, bias_init=1.0, lr_mul=0.5, generator=torch.Generator().manual_seed(0))
    assert torch.equal(mod.bias, torch.ones(5))
    assert mod.weight.shape == (5, 8)
    assert mod.scale == pytest.approx(0.5 / np.sqrt(8))


@pytest.mark.parametrize("k,no_bias", [(1, True), (3, False)])
def test_equalized_conv(k, no_bias, rng):
    x, w, b = f32(rng, 2, 8, 8, 6), f32(rng, k, k, 6, 5), f32(rng, 5)
    params = {"weight": w} if no_bias else {"weight": w, "bias": b}
    ref = j_eq.EqualizedConv2d(5, k, no_bias=no_bias).apply({"params": params}, x)
    mod = t_eq.EqualizedConv2d(6, 5, k, no_bias=no_bias)
    sd = {"weight": oihw(w)} if no_bias else {"weight": oihw(w), "bias": torch.from_numpy(b)}
    mod.load_state_dict(sd)
    np.testing.assert_allclose(nhwc(mod(nchw(x))), np.asarray(ref), **TOL)


@pytest.mark.parametrize("name", ["box_filter_3x3", "nearest_upsample_2x"])
def test_filters(name, rng):
    x = f32(rng, 2, 8, 6, 3)
    ref = getattr(j_f, name)(jnp.asarray(x))
    np.testing.assert_allclose(nhwc(getattr(t_f, name)(nchw(x))), np.asarray(ref), **TOL)


@pytest.mark.parametrize("memory_format", [torch.contiguous_format, torch.channels_last])
def test_box_filter_gradient_matches_jax(memory_format, rng):
    """The box filter's hand-routed gradient (the filter itself) against
    jax.vjp, and its first and second derivatives by finite differences."""
    x, g = f32(rng, 2, 8, 6, 3), f32(rng, 2, 8, 6, 3)
    _, vjp = jax.vjp(j_f.box_filter_3x3, jnp.asarray(x))
    xt = nchw(x).contiguous(memory_format=memory_format).requires_grad_()
    (dx,) = torch.autograd.grad(t_f.box_filter_3x3(xt), xt, nchw(g))
    np.testing.assert_allclose(nhwc(dx), np.asarray(vjp(jnp.asarray(g))[0]), **TOL)
    x64 = xt.detach().double().requires_grad_()
    assert torch.autograd.gradcheck(t_f.box_filter_3x3, (x64,))
    assert torch.autograd.gradgradcheck(t_f.box_filter_3x3, (x64,))


@pytest.mark.parametrize("gain", [1.0, float(np.sqrt(2.0))])
def test_leaky_relu(gain, rng):
    x = f32(rng, 2, 4, 4, 3)
    ref = j_f.leaky_relu(jnp.asarray(x), 0.2, gain)
    np.testing.assert_allclose(nhwc(t_f.leaky_relu(nchw(x), 0.2, gain)), np.asarray(ref), **TOL)


# (kernel, up): the block convs (3, 1), the ToRGB 1×1 (1, 1), and the block's
# up=2 transposed conv (3, 2)
@pytest.mark.parametrize("k,up", [(3, 1), (1, 1), (3, 2)])
def test_modulated_conv(k, up, rng):
    x, s = f32(rng, 2, 8, 8, 6), f32(rng, 2, 6) + 1.0
    w, b = f32(rng, k, k, 6, 5), f32(rng, 5)
    ref = j_mod.ModulatedConv2d(5, k, up=up).apply({"params": {"weight": w, "bias": b}}, x, s)
    mod = t_mod.ModulatedConv2d(6, 5, k, up=up)
    mod.load_state_dict({"weight": iohw(w) if up == 2 else oihw(w), "bias": torch.from_numpy(b)})
    out = mod(nchw(x), torch.from_numpy(s))
    assert out.shape == (2, 5, 8 * up, 8 * up)
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), **TOL)


@pytest.mark.parametrize("use_noise", [False, True])
def test_synthesis_layer(use_noise, rng):
    x, lat = f32(rng, 2, 8, 8, 6), f32(rng, 2, 10)
    w, b = f32(rng, 3, 3, 6, 4), f32(rng, 4)
    lw, lb = f32(rng, 10, 6), f32(rng, 6) + 1.0
    params = {"linear": {"weight": lw, "bias": lb}, "modulated_conv": {"weight": w, "bias": b}}
    variables = {"params": params}
    if use_noise:
        params["noise_strength"] = np.float32(3.0)
        variables["stats"] = {"noise_const": f32(rng, 16, 16)}
    ref = j_mod.SynthesisLayer(4, 10, up=2, use_noise=use_noise).apply(variables, x, lat)

    mod = t_mod.SynthesisLayer(6, 4, 10, up=2, use_noise=use_noise, resolution=16)
    sd = {
        "linear.weight": torch.from_numpy(lw.T.copy()),
        "linear.bias": torch.from_numpy(lb),
        "modulated_conv.weight": iohw(w),
        "modulated_conv.bias": torch.from_numpy(b),
    }
    if use_noise:
        sd["noise_strength"] = torch.tensor(3.0)
        sd["noise_const"] = torch.from_numpy(variables["stats"]["noise_const"])
    mod.load_state_dict(sd)
    np.testing.assert_allclose(nhwc(mod(nchw(x), torch.from_numpy(lat))), np.asarray(ref), **TOL)


def test_orthogonalize(rng):
    m = np.tanh(f32(rng, 16, 16))
    q = t_map.orthogonalize(torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(q, np.asarray(j_map.orthogonalize(jnp.asarray(m))), **TOL)
    np.testing.assert_allclose(q.T @ q, np.eye(16), atol=1e-5)


def test_mapping_network(rng):
    channels = [8, 4, 8, 16, 16]
    params = {"diagonal_params": f32(rng, 8), "basis_params": f32(rng, 8, 8)}
    for i in range(len(channels) - 1):
        params[f"mlp_{i}"] = {"weight": f32(rng, channels[i], channels[i + 1]) * 100.0,
                              "bias": f32(rng, channels[i + 1])}
    z = f32(rng, 3, 8)
    ref = j_map.MappingNetwork(channels).apply({"params": params}, z)

    mod = t_map.MappingNetwork(channels)
    sd = {"diagonal_params": torch.from_numpy(params["diagonal_params"]),
          "basis_params": torch.from_numpy(params["basis_params"])}
    for i in range(len(channels) - 1):
        sd[f"mlp_{i}.weight"] = torch.from_numpy(params[f"mlp_{i}"]["weight"].T.copy())
        sd[f"mlp_{i}.bias"] = torch.from_numpy(params[f"mlp_{i}"]["bias"])
    mod.load_state_dict(sd)
    out = mod(torch.from_numpy(z)).detach().numpy()
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)
