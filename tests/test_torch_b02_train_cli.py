"""The port's B02 training CLI (`bin/train_b02.py`) end to end on the CPU,
on tiny hdf5 dumps in B02Dataset's layout.

`--device cpu` trains both phases and writes reference-layout checkpoints;
`--resume` continues bit for bit; the checkpoint is decoded by the port's
`bin/decode_b02.py` as it is and read by the JAX package's
`convert_tacotron2` / `convert_subfreq_discriminator`; SIGTERM checkpoints
and exits 75; without `--device cpu` the CLI wants a GPU. The model is
tiny (the `SMALL` widths at 60 + 3 outputs), 20-frame batches, 4 steps.
"""

import os
import signal
import subprocess
import sys
import time

import h5py
import jax
import numpy as np
import pytest
import torch
import yaml

from svcc23_fastsvc_tpu.compat import (
    convert_subfreq_discriminator,
    convert_tacotron2,
)
from svcc23_fastsvc_tpu_torch.bin import decode_b02, train_b02

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GP = dict(input_dim=16, output_dim=60, hidden_dim=32, dec_layers=2,
          multi_speaker=True, spk_emb_dim=8, integrate_logf0=True,
          econv_chans=16, prenet_dim=8)
HOP = 120


def _config(**over):
    cfg = {
        "sampling_rate": 24000, "hop_size": HOP,
        "generator_params": GP,
        "discriminator_type": "MultiSubFreqDiscriminator",
        "discriminator_params": {"batch_max_frames": 8},
        "batch_size": 2,
        # gen_step while step <= 1: steps 1-2 gen, steps 3-4 gan
        "discriminator_train_start_steps": 1,
        "train_max_steps": 4, "save_interval_steps": 2,
        "eval_interval_steps": 2, "log_interval_steps": 2,
        "eval_batches": 1,
    }
    cfg.update(over)
    return cfg


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """Train and dev dumps, a speaker-embedding file and F0 statistics."""
    root = tmp_path_factory.mktemp("torch_b02_train")
    r = np.random.default_rng(0)
    for split, lengths in (("train", (14, 19, 23)), ("dev", (12, 17))):
        d = root / split
        d.mkdir()
        for j, nf in enumerate(lengths):
            with h5py.File(d / f"spkA_{split}{j}.h5", "w") as f:
                f["wave"] = (0.1 * r.standard_normal(nf * HOP)).astype(
                    np.float32)
                f["f0"] = r.uniform(100, 200, nf).astype(np.float32)
                f["ppg"] = r.standard_normal((nf, 16)).astype(np.float32)
                f["lft"] = r.standard_normal((nf, 1)).astype(np.float32)
                f["lf0"] = (5.0 + 0.1 * r.standard_normal((nf, 1))).astype(
                    np.float32)
                f["vuv"] = np.ones((nf, 1), np.float32)
                f["mcep"] = r.standard_normal((nf, 60)).astype(np.float32)
                f["bap"] = r.standard_normal((nf, 3)).astype(np.float32)
                f["spk_emb"] = r.standard_normal((1, 8)).astype(np.float32)
    with h5py.File(root / "spk_embs.h5", "w") as f:
        f["spkB"] = r.standard_normal(8).astype(np.float32)
    (root / "f0_stats.yml").write_text(yaml.safe_dump({
        "spkA": {"lf0_mean": float(np.log(150.0)), "lf0_scale": 0.1},
        "spkB": {"lf0_mean": float(np.log(240.0)), "lf0_scale": 0.1}}))
    return root


def _cli(dumps, outdir, cfg, *extra):
    cfg_path = os.path.join(str(dumps), f"{os.path.basename(outdir)}.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    old = signal.getsignal(signal.SIGTERM)
    try:
        train_b02.main(["--train-dumpdir", str(dumps / "train"),
                        "--dev-dumpdir", str(dumps / "dev"),
                        "--outdir", str(outdir), "--config", cfg_path,
                        "--max-frames", "20", "--device", "cpu",
                        "--verbose", "0", *extra])
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
    assert {"checkpoint-2steps.pkl", "checkpoint-4steps.pkl",
            "config.yml"} <= set(names)
    ck = torch.load(os.path.join(trained, "checkpoint-4steps.pkl"),
                    weights_only=False)
    assert ck["steps"] == 4
    # the reference wrapper's prefix on the generator's keys
    assert all(k.startswith("acoustic_network.")
               for k in ck["model"]["generator"])
    assert all(k.split(".")[0] in ("low_discriminator", "mid_discriminator",
                                   "high_discriminator")
               for k in ck["model"]["discriminator"])
    # G stepped 4 times, D only in the 2 gan steps
    assert ck["scheduler"]["generator"]["last_epoch"] == 4
    assert ck["scheduler"]["discriminator"]["last_epoch"] == 2
    assert set(ck["rng"]) == {"draws", "batcher"}
    # the batch norms' running statistics moved from their init
    sd = ck["model"]["generator"]
    assert sd["acoustic_network.bap_decoder.10.running_mean"].abs().sum() > 0
    for part in ck["model"].values():
        assert all(torch.isfinite(v).all() for v in part.values())


def test_cli_resume_continues_bit_for_bit(dumps, trained):
    """2 steps, a new run with --resume to 4: the same checkpoint as 4
    steps in one run, every tensor, moment and generator state equal."""
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
    assert torch.equal(a["rng"]["draws"], b["rng"]["draws"])
    assert a["rng"]["batcher"] == b["rng"]["batcher"]


def test_checkpoint_is_decoded_by_decode_b02(dumps, trained, tmp_path):
    """The port's decode CLI reads the training checkpoint and its
    config.yml as they are and writes finite bundles; the JAX package's
    converters read the same checkpoint into the JAX models' params."""
    out = tmp_path / "decoded"
    pkl = os.path.join(trained, "checkpoint-4steps.pkl")
    decode_b02.main([
        "--dumpdir", str(dumps / "dev"), "--checkpoint", pkl,
        "--outdir", str(out), "--spk-emb-file", str(dumps / "spk_embs.h5"),
        "--f0-stats", str(dumps / "f0_stats.yml"), "--speakers", "spkB",
        "--max-frames", "20", "--device", "cpu", "--verbose", "0"])
    names = sorted(os.listdir(out))
    assert names == ["spkA_dev0_spkB.h5", "spkA_dev1_spkB.h5"]
    with h5py.File(out / names[0]) as f:
        assert f["mcep"].shape == (12, 60) and f["bap"].shape == (12, 3)
        assert np.isfinite(f["mcep"][()]).all()
    ck = torch.load(pkl, weights_only=False)
    prefix = "acoustic_network."
    g = convert_tacotron2({k[len(prefix):]: v.numpy() for k, v in
                           ck["model"]["generator"].items()})
    d = convert_subfreq_discriminator({k: v.numpy() for k, v in
                                       ck["model"]["discriminator"].items()})
    np.testing.assert_array_equal(
        np.asarray(g["bap_decoder"]["bn"]["mean"]),
        ck["model"]["generator"][prefix + "bap_decoder.10.running_mean"])
    assert len(jax.tree.leaves(d)) == 3 * 6


def test_cli_targets_cuda_unless_told_otherwise(dumps, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg_path = tmp_path / "c.yml"
    cfg_path.write_text(yaml.safe_dump(_config()))
    with pytest.raises(RuntimeError, match="CUDA"):
        train_b02.main(["--train-dumpdir", str(dumps / "train"),
                        "--outdir", str(tmp_path / "exp"),
                        "--config", str(cfg_path), "--verbose", "0"])


LAUNCH = r"""
import sys
sys.path.insert(0, sys.argv[1])
from svcc23_fastsvc_tpu_torch.bin.train_b02 import main
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
             "--config", cfg_path, "--max-frames", "20", "--device", "cpu"],
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
    assert [n for n in os.listdir(out) if n.endswith("steps.pkl")], \
        txt[-3000:]
