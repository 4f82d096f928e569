"""The port's entry points for the train phase's last branches and the
Inception converter, on the CPU:

* ``--profile_dir``: a Chrome trace of epochs start+12 to min(start+20,
  ``--epoch``), counted from the start epoch (lcgan_tpu/train/loop.py:85-99);
  nothing, and no crash, for a run that ends before the window;
* ``--view_batched_steps`` and ``--beta1 0.5`` through the CLI;
* two gloo ranks (``tests/torch_dp_worker.py``) with view batching against
  the same two ranks without it;
* ``python -m lcgan_torch.eval.convert`` against ``python -m
  lcgan_tpu.eval.convert`` on a synthetic pytorch-fid ``.pth``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_fid import synthetic_pth  # noqa: F401 (a fixture)
from test_torch_parallel import run_ranks, write_cfg
from test_torch_train import CFG
from test_torch_train_phase import TINY, data_dir, log_lines  # noqa: F401 (data_dir is a fixture)

from lcgan_torch import cli
from lcgan_torch.config import Config
from lcgan_torch.eval import convert as tconvert
from lcgan_torch.eval.inception import InceptionV3FID
from lcgan_torch.train.loop import EpochProfiler
from lcgan_tpu.eval import convert as jconvert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads for these tiny runs: under a parallel test run,
    a thread per core in every worker oversubscribes the CPU many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def train(data, run, *flags):
    cli.main(["--phase", "train", "--dataset_path", data, "--model_name", run, *TINY, *flags])


def ranges(trace_path):
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return sorted(int(e["name"].rsplit(" ", 1)[1]) for e in events
                  if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith("train_iteration epoch "))


def test_profile_dir_traces_the_window(data_dir, tmp_path):  # noqa: F811
    """Epochs 0-20: one trace holding epochs 12-20, one range each."""
    prof = str(tmp_path / "prof")
    train(data_dir, str(tmp_path / "run"), "--epoch", "20", "--profile_dir", prof)
    assert os.listdir(prof) == ["trace_epochs_12-20_rank0.json"]
    assert ranges(os.path.join(prof, "trace_epochs_12-20_rank0.json")) == list(range(12, 21))


@pytest.mark.parametrize("start,epoch,window", [(0, 20, (12, 20)), (4, 20, (16, 20)), (0, 15, (12, 15)),
                                                (30, 100, (42, 50))])
def test_profile_window_counts_from_the_start_epoch(start, epoch, window, tmp_path):
    """The window a run resumed at ``start`` traces (lcgan_tpu/train/loop.py:85-87),
    and no profiler before it."""
    cfg = Config(model_name=str(tmp_path), epoch=epoch, profile_dir=str(tmp_path / "prof"), device="cpu")
    profiler = EpochProfiler(cfg, start, torch.device("cpu"))
    assert (profiler.first, profiler.last) == window
    with profiler.iteration(window[0] - 1):
        assert profiler.prof is None and not torch.autograd._profiler_enabled()


def test_profile_dir_short_run_writes_nothing(data_dir, tmp_path):  # noqa: F811
    prof = str(tmp_path / "prof")
    train(data_dir, str(tmp_path / "run"), "--epoch", "5", "--profile_dir", prof, "--print_interval", "1")
    assert [e for e, _, _ in log_lines(str(tmp_path / "run"))] == [0, 1, 2, 3, 4, 5]
    assert not os.path.exists(prof)


def test_cli_view_batched_steps_and_beta1(data_dir, tmp_path):  # noqa: F811
    """Two epochs (even, odd + R1) with both flags; args.txt keeps them and
    the checkpoint carries Adam's first moment."""
    run = str(tmp_path / "run")
    train(data_dir, run, "--epoch", "1", "--view_batched_steps", "--beta1", "0.5", "--print_interval", "1",
          "--save_interval", "1")
    lines = log_lines(run)
    assert [e for e, _, _ in lines] == [0, 1] and all(np.isfinite(g) and np.isfinite(d) for _, g, d in lines)
    with open(os.path.join(run, "args.txt")) as f:
        args = json.load(f)
    assert args["view_batched_steps"] is True and args["beta1"] == 0.5
    sd = torch.load(os.path.join(run, "model", "state.pt"), weights_only=True)
    assert set(sd["g_opt"]) == set(sd["d_opt"]) == {"mu", "v", "count"} and sd["g_opt"]["count"] == 2
    assert any(t.abs().sum() > 0 for t in sd["g_opt"]["mu"].values())


def test_two_ranks_view_batched_match_unbatched(tmp_path):
    """Epochs 0, 1 and 3 chained on two gloo ranks, with and without view
    batching, from one seed and the same batches and noise: losses and
    every leaf at tests/test_train.py:332-361's tolerances, and the two
    ranks bitwise equal to each other."""
    runs = {}
    for flag in (False, True):
        d = tmp_path / str(flag)
        d.mkdir()
        write_cfg(d, **{**CFG, "model_name": str(d / "run")}, device="cpu", view_batched_steps=flag)
        run_ranks(2, "train", str(d), "--epochs", "0,1,3")
        runs[flag] = [torch.load(str(d / f"group_r{r}.pt"), weights_only=False) for r in range(2)]
    for flag, (r0, r1) in runs.items():
        assert all(a[:3] == b[:3] for a, b in zip(r0, r1)), flag
        assert all(torch.equal(r1[-1][3]["generator"][k], v) for k, v in r0[-1][3]["generator"].items()), flag
    for (e, g0, d0, sd0), (e1, g1, d1, sd1) in zip(runs[False][0], runs[True][0]):
        assert e == e1
        np.testing.assert_allclose(g1, g0, rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(d1, d0, rtol=2e-5, atol=1e-6)
        for part in ("generator", "discriminator"):
            for k, v in sd0[part].items():
                tol = dict(rtol=2e-5, atol=1e-6) if k.startswith("avg_latent") else dict(rtol=2e-4, atol=2e-5)
                np.testing.assert_allclose(sd1[part][k].numpy(), v.numpy(), **tol, err_msg=f"epoch {e}: {part}.{k}")


def test_converter_cli_writes_the_jax_npz(synthetic_pth, tmp_path, capsys):  # noqa: F811
    """The same arrays under the same keys, in the same order, as the JAX
    CLI writes; both packages' loaders read it; ``--strict`` refuses a
    file that is not the reference checkpoint."""
    ours, theirs = str(tmp_path / "torch.npz"), str(tmp_path / "jax.npz")
    tconvert.main([synthetic_pth, ours])
    assert f"wrote {ours}" in capsys.readouterr().out
    jconvert.main([synthetic_pth, theirs])
    with np.load(ours) as a, np.load(theirs) as b:
        assert a.files == b.files and len(a.files) == 3 * 94
        for key in a.files:
            assert a[key].dtype == b[key].dtype == np.float32
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    params = jconvert.load_params_npz(ours)
    assert params["Mixed_5b"]["branch1x1"]["weight"].shape == (1, 1, 192, 64)  # HWIO
    from_npz = tconvert.state_dict_from_npz(ours)
    from_pth = tconvert.state_dict_from_pth(synthetic_pth)
    assert from_npz.keys() == from_pth.keys() and all(torch.equal(from_npz[k], v) for k, v in from_pth.items())
    assert InceptionV3FID().load_state_dict(from_npz) is not None

    with pytest.raises(ValueError, match="does not start with 6726825d"):
        tconvert.main([synthetic_pth, str(tmp_path / "strict.npz"), "--strict"])
    assert not os.path.exists(tmp_path / "strict.npz")
    with pytest.raises(ValueError, match="does not start with 6726825d"):
        tconvert.verify_checkpoint(synthetic_pth, strict=True)

    proc = subprocess.run([sys.executable, "-m", "lcgan_torch.eval.convert", synthetic_pth, str(tmp_path / "m.npz")],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "WARNING" in proc.stdout and os.path.exists(tmp_path / "m.npz")
