"""The port's FID (``lcgan_torch.eval``) against the JAX package's on the CPU:
each Inception block and the 299² resize under the same random parameters
(passed from Flax through the JAX converter's ``.npz`` layout), ``calc_fid``
and ``fid_real_indices``, both converters on one synthetic pytorch-fid
``.pth``, the ``fid_eval`` phase's files, and (slow) the whole 299² network
and ``fid_evaluate`` with JAX's latents.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_fid import _randomize_tf_fid, _TFFIDInception
from test_torch_cli import write_run

from lcgan_torch import cli
from lcgan_torch.eval import convert as tconvert
from lcgan_torch.eval import fid as tfid
from lcgan_torch.eval.inception import (
    BasicConv2d,
    InceptionA,
    InceptionB,
    InceptionC,
    InceptionD,
    InceptionE,
    InceptionV3FID,
    resize_299,
)
from lcgan_torch.utils.checkpoint import state_path
from lcgan_tpu.eval import convert as jconvert
from lcgan_tpu.eval import fid as jfid
from lcgan_tpu.eval import inception as jinc

# fp32 convs (XLA at Precision.HIGHEST, torch's CPU convs) summed in other orders
TOL = dict(atol=1e-5, rtol=1e-4)

# name: (Flax module, the port's module, input channels); inputs 9×9, so
# the stride-2 3×3 branches of B and D run on a 4×4 output
BLOCKS = {
    "basic_conv": (lambda: jinc.BasicConv2d(8, (3, 3), stride=2, padding=(1, 1)),
                   lambda: BasicConv2d(5, 8, 3, stride=2, padding=1), 5),
    "basic_conv_1x7": (lambda: jinc.BasicConv2d(6, (1, 7), padding=(0, 3)),
                       lambda: BasicConv2d(5, 6, (1, 7), padding=(0, 3)), 5),
    "inception_a": (lambda: jinc.InceptionA(8), lambda: InceptionA(6, 8), 6),
    "inception_b": (lambda: jinc.InceptionB(), lambda: InceptionB(6), 6),
    "inception_c": (lambda: jinc.InceptionC(8), lambda: InceptionC(6, 8), 6),
    "inception_d": (lambda: jinc.InceptionD(), lambda: InceptionD(6), 6),
    "inception_e_avg": (lambda: jinc.InceptionE("avg"), lambda: InceptionE(6, "avg"), 6),
    "inception_e_max": (lambda: jinc.InceptionE("max"), lambda: InceptionE(6, "max"), 6),
}


def randomize_bn(params, rng):
    """Non-trivial folded BatchNorm leaves, so that scale and bias are load-bearing."""
    def leaf(path, v):
        name = jax.tree_util.keystr(path)
        if "bn_scale" in name:
            return (0.5 + rng.random(v.shape)).astype(np.float32)
        if "bn_bias" in name:
            return (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        return np.asarray(v)
    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(params))


def through_npz(params, tmp_path, prefix: str):
    """Flax params → the JAX converter's .npz → the port's state_dict."""
    path = str(tmp_path / "w.npz")
    jconvert.save_params_npz({prefix: params}, path)
    sd = tconvert.state_dict_from_npz(path)
    return {k[len(prefix) + 1:]: v for k, v in sd.items()}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_matches_flax(name, tmp_path):
    make_j, make_t, cin = BLOCKS[name]
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (2, 9, 9, cin)).astype(np.float32)
    jm = make_j()
    params = randomize_bn(jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"], rng)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = make_t()
    tm.load_state_dict(through_npz(params, tmp_path, "blk"))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("size", [16, 256, 512])
def test_resize_299_matches_jax(size):
    """Bilinear, align_corners=False, no antialias: up from 16² and 256², down from 512²."""
    x = np.random.default_rng(size).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 299, 299, 3), method="bilinear", antialias=False))
    got = resize_299(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)


def test_calc_fid_and_real_indices_equal_jax():
    rng = np.random.default_rng(3)
    a, b = rng.standard_normal((40, 6)), rng.standard_normal((40, 6)) * 1.5 + 0.2
    args = (a.mean(0), np.cov(a, rowvar=False), b.mean(0), np.cov(b, rowvar=False))
    assert tfid.calc_fid(*args) == jfid.calc_fid(*args)
    few = rng.standard_normal((3, 8))  # rank-deficient covariances: the eps retry
    args = (few.mean(0), np.cov(few, rowvar=False), few.mean(0) + 1, np.cov(few[::-1] * 2, rowvar=False))
    assert tfid.calc_fid(*args) == jfid.calc_fid(*args)
    for geometry in [(100, 6, 4, 7, 0, 1), (100, 6, 4, 7, 1, 2), (33, 2, 8, 1, 0, 2), (9, 1, 9, 0, 0, 1)]:
        np.testing.assert_array_equal(tfid.fid_real_indices(*geometry), jfid.fid_real_indices(*geometry))
    with pytest.raises(ValueError, match="unique reals"):
        tfid.fid_real_indices(10, 3, 4, 0)


@pytest.fixture(scope="module")
def synthetic_pth(tmp_path_factory):
    """pytorch-fid's layout with random conv weights and BatchNorm statistics."""
    oracle = _TFFIDInception().eval()
    _randomize_tf_fid(oracle, seed=11)
    path = str(tmp_path_factory.mktemp("pth") / "rand_tf_fid.pth")
    torch.save(oracle.state_dict(), path)
    return path


def test_converters_fold_the_same_weights(synthetic_pth, tmp_path):
    """The port's .pth loader against lcgan_tpu.eval.convert's, leaf by leaf
    (HWIO → OIHW), and the port's .npz loader on the JAX converter's .npz:
    equal bit for bit; both load into the port's network."""
    params = jconvert.convert_torch_inception(synthetic_pth)
    flat = {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    from_pth = tconvert.state_dict_from_pth(synthetic_pth)
    assert len(from_pth) == len(flat) == 3 * 94  # 94 BasicConv2d
    for path, value in flat.items():
        key = path.replace("']['", ".").strip("[']")
        want = value.transpose(3, 2, 0, 1) if key.endswith(".weight") else value
        np.testing.assert_array_equal(from_pth[key].numpy(), want, err_msg=key)
    npz = str(tmp_path / "inception.npz")
    jconvert.save_params_npz(params, npz)
    from_npz = tconvert.state_dict_from_npz(npz)
    assert from_npz.keys() == from_pth.keys()
    assert all(torch.equal(from_npz[k], v) for k, v in from_pth.items())
    net = InceptionV3FID()
    assert net.load_state_dict(from_pth) is not None and net.load_state_dict(from_npz) is not None


def test_checkpoint_fingerprint(tmp_path, capsys):
    assert tconvert.EXPECTED_SHA256_PREFIX == jconvert.EXPECTED_SHA256_PREFIX == "6726825d"
    bogus = tmp_path / "not_the_weights.pth"
    bogus.write_bytes(b"definitely not an inception checkpoint")
    assert tconvert.verify_checkpoint(str(bogus)) is False
    out = capsys.readouterr().out
    assert out.startswith("WARNING") and str(bogus) in out and "does not start with 6726825d" in out


def test_fp32_convs_scope_restores_the_flags():
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with tfid.fp32_convs():
            assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


# ---------------------------------------------------------------------------
# the fid_eval phase


def image_folder(root, n: int, size: int = 16) -> str:
    d = root / "train" / "x"
    d.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8)).save(d / f"{i}.png")
    return str(root)


def test_fid_eval_phase_files_and_best_snapshot(tmp_path, capsys):
    """fid.txt on every call; best_fid.txt and state_best.pt (the evaluated
    state) only on a new best; --best generation reads state_best.pt."""
    run = str(tmp_path / "run")
    cfg = write_run(run, dataset_path=image_folder(tmp_path / "data", 4))
    argv = ["--phase", "fid_eval", "--model_name", run, "--device", "cpu"]
    cli.main(argv)
    assert "RANDOM Inception weights" in capsys.readouterr().out
    with open(os.path.join(run, "fid.txt")) as f:
        text = f.read()
    assert text.startswith("FID:") and text.endswith(" \n")
    value = float(text[4:-2])
    assert np.isfinite(value) and value >= 0
    with open(os.path.join(run, "best_fid.txt")) as f:
        assert float(f.read()) == value
    best, latest = state_path(cfg, best=True), state_path(cfg)
    want = torch.load(latest, weights_only=True)
    got = torch.load(best, weights_only=True)
    assert got.keys() == want.keys() and all(torch.equal(got["ema"][k], v) for k, v in want["ema"].items())
    stamp = os.stat(best).st_mtime_ns

    cli.main(argv)  # the same FID: no new best, state_best.pt untouched
    assert "save best model" not in capsys.readouterr().out
    assert os.stat(best).st_mtime_ns == stamp
    with open(os.path.join(run, "fid.txt")) as f:
        assert f.read() == text

    with open(os.path.join(run, "best_fid.txt"), "w") as f:
        f.write("1e30")  # any FID is a new best now
    cli.main(argv)
    assert "save best model" in capsys.readouterr().out and os.stat(best).st_mtime_ns != stamp
    with open(os.path.join(run, "best_fid.txt")) as f:
        assert float(f.read()) == value

    os.remove(latest)
    with pytest.raises(FileNotFoundError):
        cli.main(["--phase", "fake_image_generation", "--model_name", run, "--num_fakes", "1", "--device", "cpu"])
    cli.main(["--phase", "fake_image_generation", "--model_name", run, "--num_fakes", "1", "--device", "cpu",
              "--best"])
    assert os.path.exists(os.path.join(run, "fakes", "0000_images.jpg"))


# ---------------------------------------------------------------------------
# the whole network and fid_evaluate (slow: the JAX side compiles the 299² network)


@pytest.fixture(scope="module")
def inception_npz(tmp_path_factory):
    """Random Flax parameters of the whole network, BatchNorm leaves
    included, and the JAX converter's .npz of them."""
    variables = jinc.InceptionV3FID().init(jax.random.PRNGKey(2), jnp.zeros((1, 299, 299, 3)))
    params = randomize_bn(variables["params"], np.random.default_rng(4))
    path = str(tmp_path_factory.mktemp("npz") / "inception.npz")
    jconvert.save_params_npz(params, path)
    return params, path


@pytest.mark.slow
@pytest.mark.parametrize("size", [299, 256])
def test_whole_network_matches_flax(inception_npz, size):
    params, path = inception_npz
    x = np.random.default_rng(5).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    want = np.asarray(jinc.InceptionV3FID().apply({"params": params}, jnp.asarray(x)))
    net = InceptionV3FID()
    net.load_state_dict(tconvert.load_weights(path))
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (2, 2048)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=1e-3)


@pytest.mark.slow
def test_fid_evaluate_matches_jax(inception_npz, tmp_path, monkeypatch):
    """The same reals, the same EMA weights and JAX's latents through both
    packages' fid_evaluate: the feature moments within the network's
    tolerance; the FID to 1e-3 relative."""
    from lcgan_tpu.config import Config as JaxConfig
    from lcgan_tpu.train.steps import Trainer as JaxTrainer
    from lcgan_torch.config import Config
    from lcgan_torch.convert import generator_from_flax
    from lcgan_torch.models.generator import build_generator

    _, npz = inception_npz
    kw = dict(dataset_path=image_folder(tmp_path / "data", 6, size=24), model_name=str(tmp_path / "run"),
              img_resolution=32, batch_size=3, geo_noise_dim=8, app_noise_dim=8, geo_latent_dim=8,
              app_latent_dim=16, base_nf=8, max_nf=16, mbstd_group_size=2, compute_dtype="float32",
              inception_weights=npz, num_data_workers=2)
    jcfg = JaxConfig(**kw)
    jtrainer = JaxTrainer(jcfg, mesh=None)
    jstate = jtrainer.init_state()
    cfg = Config(**kw, device="cpu")
    gen = build_generator(cfg)
    gen.load_state_dict(generator_from_flax(*jax.device_get((jstate.ema_params, jstate.ema_stats))))
    gen.eval()

    def jax_latents(cfg, num_batches, local_b, rank):  # lcgan_tpu/eval/fid.py:152-157
        key, out = jax.random.PRNGKey(cfg.seed + 1 + rank), []
        for _ in range(num_batches):
            key, k1, k2 = jax.random.split(key, 3)
            out.append(tuple(torch.from_numpy(np.array(jax.random.normal(k, (local_b, d))))
                             for k, d in ((k1, cfg.geo_noise_dim), (k2, cfg.app_noise_dim))))
        return out

    moments = {}

    def recording(pkg, calc):
        def wrapped(*args):
            moments[pkg] = args
            return calc(*args)
        return wrapped

    monkeypatch.setattr(tfid, "fake_latents", jax_latents)
    monkeypatch.setattr(tfid, "calc_fid", recording("torch", tfid.calc_fid))
    monkeypatch.setattr(jfid, "calc_fid", recording("jax", jfid.calc_fid))
    want = jfid.fid_evaluate(jcfg, jtrainer, jstate)
    got = tfid.fid_evaluate(cfg, gen, torch.device("cpu"))
    for a, b in zip(moments["torch"], moments["jax"]):
        np.testing.assert_allclose(a, b, atol=1e-4 * np.abs(b).max(), rtol=1e-3)
    np.testing.assert_allclose(got, want, rtol=1e-3)
