"""The port's data parallelism (``lcgan_torch.parallel``) on the CPU over
gloo, one process a rank (``tests/torch_dp_worker.py``):

* the collectives and the ``--distributed`` policy;
* each rank's noise: its rows of the one-process draw of the global batch;
* two ranks against the JAX package's two-device mesh
  (``Trainer(cfg, mesh=make_mesh(2))`` on the conftest's fake CPU devices)
  over epochs 0, 1, 3 and 5 (even; odd + R1; odd; odd frozen), each rank
  fed its half of the same global batches and JAX's ``fold_in`` noise of its
  device: losses and every leaf within tests/test_torch_train.py's ``TOL``,
  and the two ranks' states bitwise equal;
* world size 1 through a process group bitwise equal to the plain path;
* a world-size-2 resume bit exact in fresh processes;
* the train phase under ``torchrun`` with two ranks (rank 0 alone writes).
"""

import json
import os
import socket
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import CFG, EPOCHS, TOL, leaves_with_paths
from test_torch_train_phase import TINY, data_dir, log_lines  # noqa: F401 (data_dir is a fixture)
from torch_resume_worker import CFG as RESUME_CFG

from lcgan_torch import parallel
from lcgan_torch.config import Config
from lcgan_torch.convert import flax_from_train_state, load_train_state
from lcgan_torch.train.steps import Trainer
from lcgan_torch.utils.checkpoint import read_epoch_file, save_state
from lcgan_tpu.config import Config as JaxConfig
from lcgan_tpu.parallel import make_mesh
from lcgan_tpu.train.steps import Trainer as JaxTrainer

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_dp_worker.py")
FIELDS = ("g_params", "g_stats", "d_params", "ema_params", "ema_stats", "g_opt", "d_opt")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(world: int, *args: str, timeout: int = 600) -> None:
    """``torch_dp_worker.py`` as ranks 0..world-1 of one gloo group."""
    port = str(free_port())
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, WORKER, args[0], str(r), str(world), port, *args[1:]],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-3000:]}"


def write_cfg(d, **cfg) -> str:
    with open(os.path.join(d, "cfg.json"), "w") as f:
        json.dump(cfg, f)
    return str(d)


def states_equal(a: dict, b: dict) -> list:
    """The parts of two ``TrainState.state_dict()``s that differ."""
    bad = [f"{part}.{k}" for part in ("generator", "discriminator", "ema")
           for k, v in a[part].items() if not torch.equal(b[part][k], v)]
    bad += [f"{opt}.v.{k}" for opt in ("g_opt", "d_opt") for k, v in a[opt]["v"].items()
            if not torch.equal(b[opt]["v"][k], v)]
    bad += [k for k in ("step", "rng") if not (torch.equal(a[k], b[k]) if k == "rng" else a[k] == b[k])]
    bad += [f"{opt}.count" for opt in ("g_opt", "d_opt") if a[opt]["count"] != b[opt]["count"]]
    return bad


# ---------------------------------------------------------------------------
# the collectives and the policy


def test_without_a_group_everything_is_one_process():
    assert not parallel.initialized()
    assert (parallel.rank(), parallel.world_size()) == (0, 1)
    t = [torch.randn(3), torch.randn(2, 2)]
    before = [x.clone() for x in t]
    parallel.mean_all_reduce(t)
    parallel.barrier()
    assert all(torch.equal(a, b) for a, b in zip(t, before))
    rows = np.arange(6.0).reshape(2, 3)
    assert parallel.all_gather_rows(rows) is rows


def test_initialize_policy(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert not parallel.launched()
    assert parallel.initialize("auto", "cpu") is False and parallel.initialize("off", "cpu") is False
    with pytest.raises(RuntimeError, match="torchrun"):
        parallel.initialize("on", "cpu")
    with pytest.raises(ValueError, match="auto\\|on\\|off"):
        parallel.initialize("sometimes", "cpu")
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert parallel.local_rank() == 3 and not parallel.launched()
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    assert parallel.launched() and parallel.initialize("off", "cpu") is False and not parallel.initialized()


def test_mean_all_reduce_and_all_gather_two_ranks(tmp_path):
    """One buffer, summed and divided by the world size, copied back in
    place (channels_last strides kept); one dtype only; rows in rank order."""
    run_ranks(2, "collectives", str(tmp_path))
    res = [torch.load(str(tmp_path / f"collectives_r{r}.pt"), weights_only=False) for r in range(2)]
    for r in res:
        assert (r["world"], r["channels_last"]) == (2, True)
        assert "one dtype" in r["mixed"]
        for i, after in enumerate(r["after"]):
            want = (res[0]["before"][i] + res[1]["before"][i]) / 2
            assert torch.equal(after, want), i
        want_rows = np.concatenate([np.arange(6.0).reshape(2, 3), np.arange(6.0).reshape(2, 3) + 10])
        np.testing.assert_array_equal(r["rows"].numpy(), want_rows)
    assert all(torch.equal(a, b) for a, b in zip(res[0]["after"], res[1]["after"]))


def test_two_ranks_draw_their_rows_of_the_global_noise(tmp_path):
    """Rank r's six draws of each iteration are rows r·b..(r+1)·b of the
    world-size-1 draw of the global batch from the same stream, so the ranks
    draw distinct noise, and the stream ends in the one-process state."""
    cfg = dict(CFG, batch_size=4, device="cpu", seed=5)
    run_ranks(2, "noise", write_cfg(tmp_path, **cfg))
    res = [torch.load(str(tmp_path / f"noise_r{r}.pt"), weights_only=False) for r in range(2)]
    state = SimpleNamespace(rng=torch.Generator().manual_seed(cfg["seed"]))
    trainer = Trainer(Config(**cfg))
    whole = [trainer.draw_noise(state, cfg["batch_size"]) for _ in range(2)]
    b = cfg["batch_size"] // 2
    for r, got in enumerate(res):
        assert got["world"] == 2 and torch.equal(got["rng"], state.rng.get_state()), r
        for it in range(2):
            for i, (draw, want) in enumerate(zip(got["draws"][it], whole[it])):
                assert draw.shape == (b, want.shape[1]) and torch.equal(draw, want[r * b:(r + 1) * b]), (r, it, i)
    for it in range(2):
        assert not any(torch.equal(a, c) for a, c in zip(res[0]["draws"][it], res[1]["draws"][it])), it


# ---------------------------------------------------------------------------
# two ranks against the JAX package's two-device mesh


def jax_device_noise(state, cfg, local_b: int, device: int):
    """The six draws of device ``device`` in Trainer._iteration under a mesh:
    the step key folded with the device's axis index (steps.py:107-110)."""
    _, rng_use = jax.random.split(state.rng)
    k = jax.random.split(jax.random.fold_in(rng_use, device), 6)
    dims = [cfg.geo_noise_dim, cfg.app_noise_dim] * 3
    return tuple(torch.from_numpy(np.array(jax.random.normal(k[i], (local_b, d)))) for i, d in enumerate(dims))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp")
    jcfg = JaxConfig(**CFG)
    jtrainer = JaxTrainer(jcfg, mesh=make_mesh(2))
    jstate = jtrainer.init_state()
    cfg = dict(CFG, model_name=str(d / "run"), device="cpu")
    state = Trainer(Config(**cfg)).init_state()
    load_train_state(state, jax.device_get(jstate))
    save_state(str(d / "init.pt"), state)

    rng = np.random.default_rng(0)
    batches, noise, ref = {}, {}, {}
    for epoch in EPOCHS:
        batch_np = {k: rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
                    for k in ("image", "geometry_change", "appearance_change")}
        batches[epoch] = {k: torch.from_numpy(v).permute(0, 3, 1, 2).contiguous() for k, v in batch_np.items()}
        noise[epoch] = [jax_device_noise(jstate, jcfg, 2, r) for r in range(2)]
        jstate, jg, jd = jtrainer.train_iteration(jstate, {k: jnp.asarray(v) for k, v in batch_np.items()}, epoch)
        got = jax.device_get(jstate)
        ref[epoch] = (float(jg), float(jd), {f: getattr(got, f) for f in ("step",) + FIELDS})
    torch.save(dict(batches=batches, noise=noise), str(d / "inputs.pt"))
    run_ranks(2, "train", write_cfg(d, **cfg), "--init", str(d / "init.pt"), "--inputs", str(d / "inputs.pt"),
              "--epochs", ",".join(map(str, EPOCHS)))
    ranks = [torch.load(str(d / f"group_r{r}.pt"), weights_only=False) for r in range(2)]
    return cfg, ref, ranks


@pytest.mark.parametrize("epoch", EPOCHS)
def test_two_ranks_match_the_jax_mesh(two_ranks, epoch):
    cfg, ref, ranks = two_ranks
    jg, jd, want_state = ref[epoch]
    i = EPOCHS.index(epoch)
    e, tg, td, sd = ranks[0][i]
    assert e == epoch and np.isfinite(tg) and np.isfinite(td)
    np.testing.assert_allclose(tg, jg, **TOL)
    np.testing.assert_allclose(td, jd, **TOL)
    state = Trainer(Config(**cfg)).init_state()
    state.load_state_dict(sd)
    got = flax_from_train_state(state)
    assert int(got["step"]) == int(want_state["step"]) == i + 1
    for field in FIELDS:
        want, have = leaves_with_paths(want_state[field]), leaves_with_paths(got[field])
        assert want.keys() == have.keys(), field
        for path, value in want.items():
            np.testing.assert_allclose(have[path], value, **TOL, err_msg=f"epoch {epoch}: {field}{path}")


@pytest.mark.parametrize("epoch", EPOCHS)
def test_two_ranks_stay_bitwise_equal(two_ranks, epoch):
    _, _, ranks = two_ranks
    i = EPOCHS.index(epoch)
    (e0, g0, d0, sd0), (e1, g1, d1, sd1) = ranks[0][i], ranks[1][i]
    assert (e0, g0, d0) == (e1, g1, d1)  # the losses are averaged over the ranks
    assert not states_equal(sd0, sd1)


# ---------------------------------------------------------------------------
# world size 1 and resume


def test_world_size_1_group_is_bitwise_the_plain_path(tmp_path):
    """Epochs 0-3 (even, odd + R1) without and then with a one-rank process
    group, in one process: bitwise equal states and losses."""
    d = write_cfg(tmp_path, **RESUME_CFG, model_name=str(tmp_path / "run"))
    run_ranks(1, "train", d, "--plain-first", "--epochs", "0,1,2,3")
    plain = torch.load(str(tmp_path / "plain_r0.pt"), weights_only=False)
    group = torch.load(str(tmp_path / "group_r0.pt"), weights_only=False)
    for (e, g, dl, sd), (e2, g2, dl2, sd2) in zip(plain, group):
        assert (e, g, dl) == (e2, g2, dl2) and not states_equal(sd, sd2), e


def test_world_size_2_resume_is_bit_exact(tmp_path):
    """Two ranks, epochs 0-7 (the schedule's period; frozen from 6), against
    0-3 → rank 0 saves → fresh processes restore and run 4-7: every leaf,
    both Adam trees, step and the noise stream bitwise equal, on both ranks."""
    d = write_cfg(tmp_path, **RESUME_CFG, model_name=str(tmp_path / "run"))
    run_ranks(2, "train", d, "--epochs", ",".join(map(str, range(8))), "--tag", "full")
    run_ranks(2, "train", d, "--epochs", "0,1,2,3", "--save-state", "--tag", "first")
    state_pt = os.path.join(tmp_path, "run", "model", "state.pt")
    run_ranks(2, "train", d, "--epochs", "4,5,6,7", "--init", state_pt, "--tag", "resumed")
    for r in range(2):
        full = torch.load(str(tmp_path / f"full_r{r}.pt"), weights_only=False)
        resumed = torch.load(str(tmp_path / f"resumed_r{r}.pt"), weights_only=False)
        assert [x[:3] for x in full[4:]] == [x[:3] for x in resumed]
        assert not states_equal(full[-1][3], resumed[-1][3]), r
    full = [torch.load(str(tmp_path / f"full_r{r}.pt"), weights_only=False)[-1][3] for r in range(2)]
    assert not states_equal(*full)
    # the checkpoint's layout is the one-process one
    assert set(torch.load(state_pt, weights_only=True)) == set(full[0])


# ---------------------------------------------------------------------------
# the train phase under torchrun


def test_train_phase_under_torchrun_two_ranks(data_dir, tmp_path):  # noqa: F811
    """``torchrun --nproc_per_node 2 -m lcgan_torch.cli --phase train`` on
    gloo: one log.txt line an epoch (rank 0 alone writes), the monitor's
    videos once, state.pt and epoch.txt; the global batch of 4 split 2 + 2."""
    run = str(tmp_path / "run")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
           "-m", "lcgan_torch.cli", "--phase", "train", "--dataset_path", data_dir, "--model_name", run, *TINY,
           "--epoch", "3", "--save_interval", "3", "--print_interval", "1", "--show_interval", "2"]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert proc.stdout.count("Train dataset size: 6") == 1 and proc.stdout.count("save model") == 1
    lines = log_lines(run)
    assert [e for e, _, _ in lines] == [0, 1, 2, 3]
    assert all(np.isfinite(g) and np.isfinite(d) for _, g, d in lines)
    assert read_epoch_file(run) == 3
    assert sorted(os.listdir(os.path.join(run, "samples"))) == ["appearance_2_0.mp4", "geometry_2_0.mp4"]
    sd = torch.load(os.path.join(run, "model", "state.pt"), weights_only=True)
    assert sd["step"] == 4 and not any(f.endswith(".tmp") for f in os.listdir(os.path.join(run, "model")))
