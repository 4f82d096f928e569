"""The CUDA warp kernel on the card, against the plain version.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor the JAX package, so on a GPU host without JAX it runs with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import pytest
import torch

from lcgan_torch.models.generator import Generator
from lcgan_torch.ops import warp
from lcgan_torch.ops.grid_sample import grid_sample_bicubic_plain, identity_like_coordinates

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def case(b, c, h, w, s, dtype, dev, hg=None, wg=None, seed=0):
    hg, wg = hg or h, wg or w
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, c, h, w), generator=g).to(dev, dtype).contiguous(memory_format=torch.channels_last)
    flow = torch.rand((b, hg, wg, 2), generator=g) * 2 - 1
    grid = (identity_like_coordinates(b, hg, wg) + flow * s).to(dev).contiguous()
    return x, grid


# (b, c, h, w): vector loads (C a multiple of 4/8) and the scalar path (C = 5, 3)
SHAPES = [(2, 8, 16, 16), (2, 512, 8, 8), (1, 16, 24, 40), (2, 5, 12, 20), (1, 3, 9, 7)]


@pytest.mark.parametrize("s", [0.1, 0.03])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain_fp32(shape, s, dev):
    x, grid = case(*shape, s, torch.float32, dev)
    before = warp.warp_fwd.launches
    out = warp.warp_fwd(x, grid)
    torch.cuda.synchronize()
    assert warp.warp_fwd.launches == before + 1
    assert out.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(out, grid_sample_bicubic_plain(x, grid), atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain_bf16(shape, dev):
    x, grid = case(*shape, 0.1, torch.bfloat16, dev)
    out = warp.warp_fwd(x, grid).float()
    ref = grid_sample_bicubic_plain(x, grid).float()
    # both round one fp32 sum to bf16: at most one ulp of the output scale apart
    ulp = 2.0 ** (torch.floor(torch.log2(ref.abs().max())).item() - 7)
    assert (out - ref).abs().max().item() <= ulp


def test_kernel_other_output_size_and_far_grid(dev):
    x, grid = case(1, 8, 16, 16, 0.1, torch.float32, dev, hg=5, wg=11)
    torch.testing.assert_close(warp.warp_fwd(x, grid), grid_sample_bicubic_plain(x, grid), atol=1e-5, rtol=0)
    far = torch.full_like(grid, 1e30)
    assert torch.count_nonzero(warp.warp_fwd(x, far)) == 0


def test_wrapper_refuses(dev):
    x, grid = case(1, 8, 8, 8, 0.1, torch.float32, dev)
    with pytest.raises(NotImplementedError):
        warp.grid_sample_bicubic(x.requires_grad_(), grid)
    with pytest.raises(ValueError, match="channels_last"):
        warp.warp_fwd(x.detach().contiguous(), grid)
    with pytest.raises(TypeError):
        warp.warp_fwd(x.detach(), grid.double())


def test_generator_on_card_matches_cpu(dev):
    kw = dict(img_resolution=32, geo_noise_dim=8, app_noise_dim=8, geo_latent_dim=8,
              app_latent_dim=16, base_nf=8, max_nf=16)
    cpu = Generator(**kw, generator=torch.Generator().manual_seed(0)).to(memory_format=torch.channels_last)
    card = Generator(**kw)
    card.load_state_dict(cpu.state_dict())
    card = card.to(dev, memory_format=torch.channels_last)
    z = torch.randn((2, 8), generator=torch.Generator().manual_seed(1))
    before = warp.warp_fwd.launches
    with torch.no_grad():
        ref = cpu(z, z, w_psi=0.7)
        out = card(z.to(dev), z.to(dev), w_psi=0.7)
    assert warp.warp_fwd.launches == before + card.num_blocks
    torch.testing.assert_close(out.cpu(), ref, atol=1e-4, rtol=1e-4)
