"""The port's training CLI end to end on the CPU, on tiny hdf5 dumps.

`bin/train_fastsvc.py --device cpu` trains both phases and writes
reference-layout checkpoints; `--resume` continues bit for bit; SIGTERM
checkpoints and exits 75; the JAX package's `convert_fastsvc_checkpoint`
reads the port's checkpoint. The model is tiny (two narrow blocks,
400-sample crops, 4 steps).
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import yaml

import jax

from svcc23_fastsvc_tpu.compat import (
    convert_fastsvc_generator,
    convert_melgan_msd,
)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEN = dict(in_channels=8, mid_channels=[16, 8], upsampling_scales=[4, 5],
           spk_emb_size=12, use_spk_emb=True)
STFT = ((64, 128), (16, 32), (64, 128))
SR, HOP = 4000, 20


def _utterances(n, seed):
    r = np.random.default_rng(seed)
    for j in range(n):
        nf = 30 + 7 * j
        yield (f"spk_utt{j}",
               r.standard_normal(nf * HOP).astype(np.float32),
               r.uniform(80, 300, nf).astype(np.float32),
               r.standard_normal((nf, 8)).astype(np.float32),
               r.standard_normal(nf * HOP).astype(np.float32),
               r.standard_normal((1, 12)).astype(np.float32))


# -- the CLI --------------------------------------------------------------


def _config(**over):
    cfg = {
        "sampling_rate": SR, "hop_size": HOP,
        "generator_params": GEN,
        "discriminator_params": {"scales": 2, "channels": 4,
                                 "max_downsample_channels": 32,
                                 "downsample_scales": [4, 4]},
        "stft_loss_params": {"fft_sizes": list(STFT[0]),
                             "hop_sizes": list(STFT[1]),
                             "win_lengths": list(STFT[2])},
        "batch_size": 2, "batch_length": 400,
        "signal_generator": {"sine_amp": 0.1, "noise_amp": 0.003,
                             "signal_types": ["sine"]},
        # gen_step while step <= 1, as in the JAX trainer: steps 1-2 gen,
        # steps 3-4 gan
        "discriminator_train_start_steps": 1,
        "train_max_steps": 4, "save_interval_steps": 2,
        "eval_interval_steps": 2, "log_interval_steps": 2,
        "eval_batches": 1,
    }
    cfg.update(over)
    return cfg


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """Train and dev hdf5 dumps in the FastSVCDataset layout."""
    from svcc23_fastsvc_tpu.data.hdf5 import write_hdf5

    root = tmp_path_factory.mktemp("torch_train")
    for split, seed in (("train", 12), ("dev", 13)):
        d = root / split
        d.mkdir()
        for utt, wave, f0, ppg, lft, emb in _utterances(3, seed):
            path = str(d / f"{utt}.h5")
            for name, a in (("wave", wave), ("f0", f0), ("ppg", ppg),
                            ("lft", lft), ("spk_emb", emb)):
                write_hdf5(path, name, a)
    return root


def _cli(dumps, outdir, cfg, *extra):
    from svcc23_fastsvc_tpu_torch.bin.train_fastsvc import main

    cfg_path = os.path.join(str(dumps), f"{os.path.basename(outdir)}.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    old = signal.getsignal(signal.SIGTERM)
    try:
        main(["--train-dumpdir", str(dumps / "train"),
              "--dev-dumpdir", str(dumps / "dev"), "--outdir", str(outdir),
              "--config", cfg_path, "--device", "cpu", "--verbose", "0",
              *extra])
    finally:
        signal.signal(signal.SIGTERM, old)


@pytest.fixture(scope="module")
def trained(dumps):
    """4 steps of the CLI (2 gen, 2 gan) in one run."""
    out = dumps / "exp_full"
    _cli(dumps, out, _config())
    return out


def test_cli_trains_both_phases_on_hdf5_dumps(trained):
    names = sorted(os.listdir(trained))
    assert "checkpoint-2steps.pkl" in names
    assert "checkpoint-4steps.pkl" in names
    assert "config.yml" in names
    ck = torch.load(os.path.join(trained, "checkpoint-4steps.pkl"),
                    weights_only=False)
    assert ck["steps"] == 4
    assert set(ck["model"]) == {"generator", "discriminator"}
    assert set(ck["optimizer"]) == set(ck["scheduler"]) == {
        "generator", "discriminator"}
    # G stepped 4 times, D only in the 2 gan steps
    assert ck["scheduler"]["generator"]["last_epoch"] == 4
    assert ck["scheduler"]["discriminator"]["last_epoch"] == 2
    for sd in ck["model"].values():
        assert all(torch.isfinite(v).all() for v in sd.values())


def test_cli_resume_continues_bit_for_bit(dumps, trained):
    """2 steps, a new run with --resume to 4: the same checkpoint as 4
    steps in one run, every tensor equal."""
    out = dumps / "exp_resumed"
    _cli(dumps, out, _config(train_max_steps=2))
    _cli(dumps, out, _config(), "--resume")
    a = torch.load(os.path.join(trained, "checkpoint-4steps.pkl"),
                   weights_only=False)
    b = torch.load(os.path.join(out, "checkpoint-4steps.pkl"),
                   weights_only=False)
    for who in ("generator", "discriminator"):
        for k, v in a["model"][who].items():
            assert torch.equal(v, b["model"][who][k]), (who, k)
        for i, st in a["optimizer"][who]["state"].items():
            other = b["optimizer"][who]["state"][i]
            assert torch.equal(st["exp_avg"], other["exp_avg"])
            assert torch.equal(st["exp_avg_sq"], other["exp_avg_sq"])
    assert a["rng"]["batcher"] == b["rng"]["batcher"]


def test_port_checkpoint_is_read_by_the_jax_converter(dumps, trained):
    """svcc23_fastsvc_tpu/bin/convert_checkpoint.py reads G and D from the
    port's checkpoint; the converted params are the port's weights."""
    from svcc23_fastsvc_tpu.bin.convert_checkpoint import (
        convert_fastsvc_checkpoint,
    )
    from svcc23_fastsvc_tpu.config import build_train_task, load_config
    from svcc23_fastsvc_tpu.train.checkpoint import load_checkpoint

    pkl = os.path.join(trained, "checkpoint-4steps.pkl")
    cfg_path = os.path.join(trained, "config.yml")
    outdir = str(dumps / "converted")
    assert convert_fastsvc_checkpoint(pkl, cfg_path, outdir) == 4
    target = build_train_task(load_config(cfg_path)).init_state(
        jax.random.PRNGKey(0))
    state, step = load_checkpoint(outdir, target)
    assert step == 4
    ck = torch.load(pkl, weights_only=False)
    for got, want in (
            (state.g_params, convert_fastsvc_generator(
                ck["model"]["generator"])),
            (state.d_params, convert_melgan_msd(
                ck["model"]["discriminator"], scales=2))):
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


LAUNCH = r"""
import sys
sys.path.insert(0, sys.argv[1])
from svcc23_fastsvc_tpu_torch.bin.train_fastsvc import main
main(sys.argv[2:])
"""


def test_sigterm_checkpoints_and_exits_75(dumps):
    out = dumps / "exp_sigterm"
    cfg_path = str(dumps / "sigterm.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(_config(train_max_steps=100000,
                               save_interval_steps=100000,
                               eval_interval_steps=100000,
                               log_interval_steps=1), f)
    log_path = dumps / "sigterm.log"
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-c", LAUNCH, REPO,
             "--train-dumpdir", str(dumps / "train"), "--outdir", str(out),
             "--config", cfg_path, "--device", "cpu"],
            stdout=log, stderr=subprocess.STDOUT, cwd=REPO)
        try:
            deadline = time.time() + 120
            while time.time() < deadline and proc.poll() is None:
                if "steps_per_s" in log_path.read_text():
                    break
                time.sleep(0.2)
            assert "steps_per_s" in log_path.read_text(), \
                log_path.read_text()[-3000:]
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    txt = log_path.read_text()
    assert rc == 75, txt[-3000:]
    assert "preempted at step" in txt
    ckpts = [n for n in os.listdir(out) if n.endswith("steps.pkl")]
    assert ckpts, txt[-3000:]
