"""The port's training CLI across processes, on the CPU: the counterpart of
test_multihost_cli.py.

Two `python -m svcc23_fastsvc_tpu_torch.bin.train_fastsvc --device cpu
--n-procs 2 --proc-id I --coordinator 127.0.0.1:P` processes join over
gloo, each trains on its own half of the global batch from its own
seeded stream, and rank 0 writes config.yml and the checkpoints. Both
exit 0 and log the same parameter checksum (the replicas stay equal bit
for bit); a global batch that does not split over the processes raises;
`--n-devices 2` starts both ranks from one command.
The dumps are hdf5 files in the FastSVCDataset layout, written with the
port's own codec; the model is tiny (test_torch_train_cli.py's), 4 steps
(2 gen, 2 gan).
"""

import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from svcc23_fastsvc_tpu_torch.data.hdf5 import write_hdf5

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR, HOP = 4000, 20
TIMEOUT_S = 240


def _config(**over):
    cfg = {
        "sampling_rate": SR, "hop_size": HOP,
        "generator_params": {"in_channels": 8, "mid_channels": [16, 8],
                             "upsampling_scales": [4, 5],
                             "spk_emb_size": 12, "use_spk_emb": True},
        "discriminator_params": {"scales": 2, "channels": 4,
                                 "max_downsample_channels": 32,
                                 "downsample_scales": [4, 4]},
        "stft_loss_params": {"fft_sizes": [64, 16], "hop_sizes": [16, 4],
                             "win_lengths": [64, 16]},
        "batch_size": 4,  # global: 2 rows a process
        "batch_length": 400,
        "signal_generator": {"sine_amp": 0.1, "noise_amp": 0.003,
                             "signal_types": ["sine"]},
        "discriminator_train_start_steps": 1,  # steps 1-2 gen, 3-4 gan
        "train_max_steps": 4, "save_interval_steps": 4,
        "eval_interval_steps": 100, "log_interval_steps": 2,
    }
    cfg.update(over)
    return cfg


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_mh_cli")
    r = np.random.default_rng(3)
    (root / "train").mkdir()
    for j in range(4):
        nf = 30 + 5 * j
        path = str(root / "train" / f"spk_utt{j}.h5")
        for name, a in (
                ("wave", 0.3 * r.standard_normal(nf * HOP)),
                ("f0", r.uniform(80, 300, nf)),
                ("ppg", r.standard_normal((nf, 8))),
                ("lft", r.standard_normal(nf * HOP)),
                ("spk_emb", r.standard_normal((1, 12)))):
            write_hdf5(path, name, a.astype(np.float32))
    return root


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(dumps, outdir, cfg):
    cfg_path = str(outdir) + ".yml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "svcc23_fastsvc_tpu_torch.bin.train_fastsvc",
         "--train-dumpdir", str(dumps / "train"), "--outdir", str(outdir),
         "--config", cfg_path, "--device", "cpu", "--n-procs", "2",
         "--proc-id", str(i), "--coordinator", coordinator],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    try:
        outs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return procs, outs


def test_two_process_cli_training(dumps, tmp_path):
    outdir = tmp_path / "exp"
    procs, outs = _launch(dumps, outdir, _config())
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        assert "data-parallel over 2 devices (2 processes)" in out
    sums = [re.findall(r"rank (\d) parameter checksum: (\w+)", out)
            for out in outs]
    assert [s[0][0] for s in sums] == ["0", "1"], sums
    assert sums[0][0][1] == sums[1][0][1]
    names = os.listdir(outdir)
    assert "config.yml" in names
    assert [n for n in names if n.endswith(".pkl")] == [
        "checkpoint-4steps.pkl"]
    # rank 0's scalars only, where tensorboardX is installed
    assert sum(n.startswith("events.out.tfevents") for n in names) <= 1
    ck = torch.load(outdir / "checkpoint-4steps.pkl", weights_only=False)
    assert ck["steps"] == 4
    assert ck["scheduler"]["generator"]["last_epoch"] == 4
    assert ck["scheduler"]["discriminator"]["last_epoch"] == 2
    for sd in ck["model"].values():
        assert all(torch.isfinite(v).all() for v in sd.values())


def test_batch_size_must_split_over_the_processes(dumps, tmp_path):
    procs, outs = _launch(dumps, tmp_path / "exp", _config(batch_size=3))
    for p, out in zip(procs, outs):
        assert p.returncode != 0
        assert "batch_size 3 not divisible by 2 processes" in out


def test_n_devices_starts_the_local_ranks(dumps, tmp_path):
    """`--n-devices 2` in one command starts both ranks through the
    launcher's local backend (logs under <outdir>/log) and waits for them."""
    outdir = tmp_path / "exp"
    cfg_path = str(tmp_path / "cfg.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(_config(), f)
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    done = subprocess.run(
        [sys.executable, "-m", "svcc23_fastsvc_tpu_torch.bin.train_fastsvc",
         "--train-dumpdir", str(dumps / "train"), "--outdir", str(outdir),
         "--config", cfg_path, "--device", "cpu", "--n-devices", "2"],
        env=env, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert done.returncode == 0, done.stdout[-3000:] + done.stderr[-3000:]
    sums = []
    for r in range(2):
        text = (outdir / "log" / f"train.{r}.log").read_text()
        assert "data-parallel over 2 devices (2 processes)" in text
        sums += re.findall(rf"rank {r} parameter checksum: (\w+)", text)
    assert len(sums) == 2 and sums[0] == sums[1]
    assert (outdir / "checkpoint-4steps.pkl").exists()

