"""The plain reference against lcgan_torch on the CPU at the dryrun widths:
the parameter names and shapes, the generator in eval mode, every variant
of the training iteration (epochs 0-3: even, odd with R1, even, odd)
chained from one set of weights, and the training views against the
port's pipeline on both of its paths."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from lcgan_torch.config import Config
from lcgan_torch.data.dataset import ImageFolderDataset, TrainInputPipeline
from lcgan_torch.native import available as native_available
from lcgan_torch.train.steps import Trainer
from portbench import traffic
from portbench.reference import model, train, views
from portbench.tests.tiny import FLAGS

CPU = torch.device("cpu")
SIZES = model.Sizes.of(FLAGS)
BATCH = 4


def _port(seed: int = 5):
    cfg = Config(model_name="unused", batch_size=BATCH, device="cpu", seed=seed,
                 **{k: v for k, v in FLAGS.items() if k != "freezeD_start"})
    trainer = Trainer(cfg)
    return cfg, trainer, trainer.init_state()


@pytest.mark.parametrize("net", ["generator", "discriminator"])
def test_spec_is_the_ports_state_dict(net):
    _, _, st = _port()
    spec = {n: s for n, s, _ in getattr(model, f"{net}_spec")(SIZES)}
    port = {k: tuple(v.shape) for k, v in getattr(st, net).state_dict().items()}
    assert spec == port


@pytest.mark.parametrize("resolution,base", [(256, 128), (512, 64)])
def test_spec_at_the_configurations_widths(resolution, base):
    """Parameter counts of the benchmark's configurations (G 28.11 M / 28.16 M,
    D 64.78 M / 64.90 M)."""
    s = model.Sizes.of({"img_resolution": resolution, "base_nf": base})
    count = lambda spec: sum(int(np.prod(shape)) for n, shape, _ in spec if n not in model.BUFFERS)  # noqa: E731
    g, d = count(model.generator_spec(s)) / 1e6, count(model.discriminator_spec(s)) / 1e6
    assert (round(g, 2), round(d, 2)) == ({256: (28.11, 64.78), 512: (28.16, 64.90)}[resolution])


def test_generator_eval_matches_the_port():
    from lcgan_torch.train.loop import load_ema_generator

    cfg, _, _ = _port()
    wg = model.make_weights([model.generator_spec(SIZES)], 3, CPU)[0]
    gen = load_ema_generator(cfg, CPU, {"ema": wg})
    z1, z2 = torch.randn(BATCH, SIZES.geo_noise_dim), torch.randn(BATCH, SIZES.app_noise_dim)
    with torch.inference_mode():
        port = gen(z1, z2, w_psi=0.7)
    with model.reference_mode(), torch.no_grad():
        ref = model.generator(wg, SIZES, z1, z2, w_psi=0.7, training=False)
    assert torch.allclose(port, ref, atol=1e-5, rtol=1e-5)


def test_training_iterations_match_the_port():
    """Four chained iterations in float32: losses to 1e-5, every leaf and
    the EMA to Adam's amplification of rounding (a leaf whose gradient is
    near 0 moves by ±lr either way: the mapping nets' QR bases)."""
    _, trainer, st = _port()
    wg, wd = model.make_weights([model.generator_spec(SIZES), model.discriminator_spec(SIZES)], 7, CPU)
    st.generator.load_state_dict(wg)
    st.ema.load_state_dict(wg)
    st.discriminator.load_state_dict(wd)
    ref = train.State.start(wg, wd)
    noise = train.noise_draws(SIZES, BATCH, 5, 4, CPU)
    rng = np.random.default_rng(0)
    recipe = train.Recipe.of(FLAGS)
    with model.reference_mode():
        for epoch in range(4):
            batch = {k: torch.from_numpy(rng.uniform(-1, 1, (BATCH, 3, 32, 32)).astype(np.float32))
                     for k in ("image", "geometry_change", "appearance_change")}
            _, g_loss, d_loss = trainer.train_iteration(st, batch, epoch)
            rg, rd, _, _ = train.iteration(ref, SIZES, recipe, batch, noise[epoch], epoch)
            assert abs(float(g_loss) - float(rg)) <= 1e-5 * abs(float(rg))
            assert abs(float(d_loss) - float(rd)) <= 1e-5 * abs(float(rd))
    for port, mine in ((st.generator, ref.g), (st.discriminator, ref.d), (st.ema, ref.ema)):
        for k, v in port.state_dict().items():
            tol = 1e-2 if "basis_params" in k else 1e-4
            assert (v - mine[k]).abs().max() <= tol, k


@pytest.mark.parametrize("native", [False, True])
def test_views_match_the_ports_pipeline(tmp_path, native):
    if native and not native_available():
        pytest.skip("the native loader does not build here (no libjpeg or libpng headers)")
    seed = 2**31 + 5
    files = traffic.jpeg_folder(str(tmp_path), seed, 10, 48, 90)
    dataset = ImageFolderDataset(str(tmp_path), 48, True, seed=seed)
    pipeline = TrainInputPipeline(dataset, batch_size=4, num_workers=2, seed=seed, use_native=native)
    got = [next(pipeline) for _ in range(5)]  # across a data epoch's end
    ref = views.batches(files, 48, 4, seed, 5, native)
    for g, r in zip(got, ref):
        for k in r:
            assert np.array_equal(g[k].numpy(), r[k]), k


def test_views_differ_from_another_seed(tmp_path):
    files = traffic.jpeg_folder(str(tmp_path), 1, 8, 32, 90)
    a = views.batches(files, 32, 4, 1, 1, False)[0]
    b = views.batches(files, 32, 4, 2, 1, False)[0]
    assert not np.array_equal(a["geometry_change"], b["geometry_change"])


@pytest.mark.parametrize("index", [0, 1, 3])
def test_blocks_of_rows_give_the_whole_batchs_iteration(index):
    """Blocks of whole minibatch-stddev groups (rows m, m + 2 at a batch of
    4 in groups of 2): the same losses, gradients and state."""
    wg, wd = model.make_weights([model.generator_spec(SIZES), model.discriminator_spec(SIZES)], 9, CPU)
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.uniform(-1, 1, (BATCH, 3, 32, 32)).astype(np.float32))
             for k in ("image", "geometry_change", "appearance_change")}
    noise = train.noise_draws(SIZES, BATCH, 9, 1, CPU)[0]
    recipe = train.Recipe.of(FLAGS)
    out = []
    with model.reference_mode():
        for blocks in (1, BATCH // SIZES.mbstd_group_size):
            st = train.State.start(wg, wd)
            out.append((train.iteration(st, SIZES, recipe, batch, noise, index, blocks=blocks), st))
    (g1, d1, gg1, dg1), st1 = out[0]
    (g2, d2, gg2, dg2), st2 = out[1]
    assert torch.allclose(g1, g2, rtol=1e-5) and torch.allclose(d1, d2, rtol=1e-5)
    for a, b in ((gg1, gg2), (dg1, dg2)):
        for k in a:
            assert torch.allclose(a[k], b[k], rtol=1e-4, atol=1e-5 * float(a[k].abs().max()) + 1e-12), k  # sums in another order
    for k in st1.g:
        if k in model.BUFFERS:
            assert torch.allclose(st1.g[k], st2.g[k], rtol=1e-5, atol=1e-7), k
