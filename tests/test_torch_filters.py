"""What the pool wrappers of ``lcgan_torch.ops.filters`` decide on the host,
on the CPU: the output's memory format against ATen's, the kernel's path
(vector, narrow or strided) from dtype, shape, strides and alignment, the
box filter's strip height, what the wrappers refuse, and the autograd
Functions the card runs, through the plain versions. The kernels themselves
run in tests/test_torch_cuda.py."""

import pytest
import torch
import torch.nn.functional as F

from lcgan_torch.ops import filters as f

CL = torch.channels_last


def _randn(*shape, dtype=torch.float32, seed=0):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)).to(dtype)


# tensors whose memory format ATen must decide: dense in either format, the
# ambiguous shapes (C = 1, a 1x1 map, H = 1), views with gaps, permutes and
# an expanded cotangent (all strides 0)
FORMAT_CASES = {
    "nchw": lambda: _randn(2, 8, 6, 5),
    "cl": lambda: _randn(2, 8, 6, 5).contiguous(memory_format=CL),
    "c1_nchw": lambda: _randn(2, 1, 6, 5),
    "c1_cl": lambda: _randn(2, 1, 6, 5).contiguous(memory_format=CL),
    "map1x1_nchw": lambda: _randn(2, 8, 1, 1),
    "map1x1_cl": lambda: _randn(2, 8, 1, 1).contiguous(memory_format=CL),
    "h1_cl": lambda: _randn(2, 8, 1, 5).contiguous(memory_format=CL),
    "n1_cl": lambda: _randn(1, 8, 6, 5).contiguous(memory_format=CL),
    "cl_sliced_w": lambda: _randn(2, 8, 6, 10).contiguous(memory_format=CL)[..., ::2],
    "nchw_sliced_c": lambda: _randn(2, 16, 6, 5)[:, ::2],
    "nhwc_permuted": lambda: _randn(2, 6, 5, 8).permute(0, 3, 1, 2),
    "hw_transposed": lambda: _randn(2, 8, 5, 6).transpose(2, 3),
    "expanded": lambda: torch.ones(1).expand(2, 8, 6, 5),
}


@pytest.mark.parametrize("case", sorted(FORMAT_CASES))
def test_plan_matches_aten(case):
    """Each wrapper's plan: ATen's output shape and strides (forward, and the
    2x2 gradient in the pool's input's format; ``channels_last_like`` is
    ATen's rule) and the launch's sizes."""
    x = FORMAT_CASES[case]()
    plan = f._plan("box_filter", x.shape, x.stride(), x.dtype, tuple(x.shape[2:]), None)
    ref = F.avg_pool2d(x, 3, stride=1, padding=1)
    assert (plan.out_shape, plan.out_strides) == (tuple(ref.shape), ref.stride())
    assert plan.sizes[:4] == plan.narrow_sizes[:4] == tuple(x.shape)
    if min(x.shape[2:]) < 2:
        return
    h, w = x.shape[2:]
    plan = f._plan("pool2x2", x.shape, x.stride(), x.dtype, (h // 2, w // 2), None)
    xr = x.detach().requires_grad_()
    ref = F.avg_pool2d(xr, 2, stride=2)
    assert (plan.out_shape, plan.out_strides) == (tuple(ref.shape), ref.stride())
    g = torch.ones_like(ref)
    (dx,) = torch.autograd.grad(ref, xr, g)
    plan = f._plan("pool2x2_grad", g.shape, g.stride(), g.dtype, (h, w), f._format(x.shape, x.stride()))
    assert (plan.out_shape, plan.out_strides, plan.sizes) == (tuple(dx.shape), dx.stride(), tuple(x.shape))


# (dtype, the output's shape, channels_last, byte offsets of the two pointers, path)
PATH_CASES = [
    (torch.bfloat16, (8, 64, 512, 512), True, (0, 0), "vector"),  # the 512² maps
    (torch.bfloat16, (8, 8, 7, 5), True, (0, 0), "vector"),  # one 16-byte vector a pixel
    (torch.float32, (8, 4, 7, 5), True, (0, 0), "vector"),
    (torch.float32, (8, 128, 64, 64), True, (0, 512), "vector"),
    (torch.bfloat16, (8, 64, 64, 64), True, (2, 0), "narrow"),  # the input off 16 bytes
    (torch.bfloat16, (8, 64, 64, 64), True, (0, 8), "narrow"),  # the output off 16 bytes
    (torch.bfloat16, (32, 2, 512, 512), True, (0, 0), "narrow"),  # the generator's flow
    (torch.bfloat16, (8, 3, 7, 5), True, (0, 0), "narrow"),
    (torch.float32, (8, 130, 7, 5), True, (0, 0), "narrow"),  # 520 bytes a pixel
    (torch.bfloat16, (8, 130, 7, 5), True, (0, 0), "narrow"),  # 260
    (torch.float32, (8, 2, 64, 64), True, (0, 0), "narrow"),
    (torch.bfloat16, (8, 64, 64, 64), False, (0, 0), "strided"),  # an NCHW cotangent
    (torch.float32, (1, 3, 2, 3), False, (0, 0), "strided"),
    (torch.bfloat16, (8, 64, 1, 1), True, (0, 0), "vector"),  # a 1x1 map, channels_last strides
    (torch.bfloat16, (8, 64, 1, 1), False, (0, 0), "strided"),  # the same memory, NCHW strides
]


def _strides(shape, channels_last):
    return torch.empty(shape, device="meta", memory_format=CL if channels_last else torch.contiguous_format).stride()


@pytest.mark.parametrize("dtype,shape,channels_last,offsets,path", PATH_CASES)
def test_pool_path(dtype, shape, channels_last, offsets, path):
    addrs = [0x7F0000000000 + o for o in offsets]
    assert f.pool_path(dtype, shape, _strides(shape, channels_last), addrs) == path


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int32])
def test_pool_path_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError):
        f.pool_path(dtype, (2, 8, 4, 4), _strides((2, 8, 4, 4), True), (0, 0))


def test_pool_path_refuses_other_ranks():
    with pytest.raises(ValueError):
        f.pool_path(torch.float32, (8, 4, 4), (16, 4, 1), (0, 0))


# (N, C, H, W, channels a thread, rows)
ROWS_CASES = [
    (32, 64, 512, 512, 8, 8),  # 512²·C64 at batch 32
    (8, 64, 512, 512, 8, 8),
    (8, 128, 256, 256, 8, 8),
    (32, 2, 512, 512, 1, 8),  # the flow, one element a thread
    (32, 512, 64, 64, 8, 8),
    (32, 512, 32, 32, 8, 4),  # 64 K threads a row of strips: halved once
    (8, 512, 8, 8, 8, 1),  # gen's smallest maps: one row a thread
    (1, 8, 1, 1, 8, 1),
]


@pytest.mark.parametrize("n,c,h,w,vec,rows", ROWS_CASES)
def test_box_rows(n, c, h, w, vec, rows):
    assert f.box_rows(n, c, h, w, vec) == rows


@pytest.mark.parametrize("name", ["box_filter", "pool2x2", "pool2x2_grad"])
def test_wrappers_refuse(name):
    """Another dtype, another rank, or a tensor off the card: the wrappers
    raise before any build or launch."""
    call = {"box_filter": f.box_filter, "pool2x2": f.pool2x2,
            "pool2x2_grad": lambda t: f.pool2x2_grad(t, 2 * t.shape[-2], 2 * t.shape[-1])}[name]
    with pytest.raises(TypeError):
        call(_randn(2, 8, 4, 4, dtype=torch.float16))
    with pytest.raises(TypeError):
        call(_randn(2, 8, 4, 4, dtype=torch.float64))
    with pytest.raises(ValueError):
        call(_randn(8, 4, 4))
    with pytest.raises(ValueError):
        call(_randn(2, 8, 4, 4))  # a CPU tensor
    assert getattr(f, name).launches == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw", [(2, 3), (3, 2), (7, 5), (8, 8)])
def test_pool2x2_grad_plain_matches_aten(hw, dtype):
    """The plain gradient (g / 4 spread, zero-padded) equals ATen's
    avg_pool2d backward bitwise, odd maps included."""
    h, w = hw
    x = _randn(2, 3, h, w, dtype=dtype).requires_grad_()
    g = _randn(2, 3, h // 2, w // 2, dtype=dtype, seed=1)
    (ref,) = torch.autograd.grad(F.avg_pool2d(x, 2, stride=2), x, g)
    assert torch.equal(f.pool2x2_grad_plain(g, h, w), ref)


@pytest.mark.parametrize("hw", [(6, 4), (7, 5)])
def test_pool_functions_are_twice_differentiable(hw):
    """The Functions the card runs (the 2x2 pool, its gradient as a Function,
    and the box filter), through their plain versions: first and second
    derivatives by finite differences."""
    h, w = hw
    x = _randn(2, 3, h, w, dtype=torch.float64).requires_grad_()
    g = _randn(2, 3, h // 2, w // 2, dtype=torch.float64, seed=1).requires_grad_()
    assert torch.autograd.gradcheck(f.AvgPool2x2.apply, (x,))
    assert torch.autograd.gradgradcheck(f.AvgPool2x2.apply, (x,))
    assert torch.autograd.gradcheck(lambda t: f.Pool2x2Grad.apply(t, h, w, torch.contiguous_format), (g,))
    assert torch.autograd.gradgradcheck(lambda t: f.Pool2x2Grad.apply(t, h, w, torch.contiguous_format), (g,))
    assert torch.autograd.gradgradcheck(f.BoxFilter3x3.apply, (x,))


@pytest.mark.parametrize("memory_format", [torch.contiguous_format, CL])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_path_is_atens_pool(memory_format, dtype):
    """On the CPU both pools are ATen's, forward and gradient, bitwise, and
    no kernel is counted."""
    x = _randn(2, 8, 7, 6, dtype=dtype).contiguous(memory_format=memory_format)
    g3, g2 = _randn(2, 8, 7, 6, dtype=dtype, seed=1), _randn(2, 8, 3, 3, dtype=dtype, seed=2)
    ours, ref = x.clone().requires_grad_(), x.clone().requires_grad_()
    y3, y2 = f.box_filter_3x3(ours), f.avg_pool_2x2(ours)
    r3, r2 = F.avg_pool2d(ref, 3, stride=1, padding=1), F.avg_pool2d(ref, 2, stride=2)
    assert torch.equal(y3, r3) and torch.equal(y2, r2)
    assert y3.stride() == r3.stride() and y2.stride() == r2.stride()
    (d2,) = torch.autograd.grad(y2, ours, g2)
    (e2,) = torch.autograd.grad(r2, ref, g2)
    assert torch.equal(d2, e2)
    (d3,) = torch.autograd.grad(f.box_filter_3x3(ours), ours, g3)
    assert torch.equal(d3, F.avg_pool2d(g3, 3, stride=1, padding=1))
    assert (f.box_filter.launches, f.pool2x2.launches, f.pool2x2_grad.launches) == (0, 0, 0)
