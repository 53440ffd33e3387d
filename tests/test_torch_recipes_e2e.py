"""Both recipe drivers of the port from wavs to converted wavs on the CPU,
as they run on the card's machine.

`python -m svcc23_fastsvc_tpu_torch.recipes.fastsvc1` (stages 0-5) and
`.baseline02` (stages 0-5 and 7, a seeded HN-uSFGAN `.pkl` as the
vocoder) run at once, each in a fresh interpreter, with `--device cpu`,
stage 1 at `--n-jobs 2` through the local launcher, at narrow widths
(a few steps of training). The interpreters' PYTHONPATH carries a
`sitecustomize.py` that makes `jax`, the JAX package, `h5py` and `joblib`
impossible to import, in the drivers and in every CLI process they start:
the port's own HDF5 codec and stats files carry the recipe. Afterwards the
JAX package reads the dumps (`read_hdf5`, through h5py) and the stats
(`load_scaler`, through joblib), each dataset equal bit for bit to what
the port reads, each scaler's transform equal to the port's.
"""

import glob
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import yaml

from svcc23_fastsvc_tpu.data.hdf5 import read_hdf5 as jax_read_hdf5
from svcc23_fastsvc_tpu.utils.scalers import load_scaler as jax_load_scaler
from svcc23_fastsvc_tpu_torch.bin.common import read_wav, write_wav
from svcc23_fastsvc_tpu_torch.data.hdf5 import read_hdf5_all
from svcc23_fastsvc_tpu_torch.utils.scalers import load_scaler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ABSENT = '''import sys


class _Absent:
    """What the card's machine lacks, and the JAX package."""

    NAMES = {"jax", "jaxlib", "svcc23_fastsvc_tpu", "h5py", "joblib"}

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in self.NAMES:
            raise ModuleNotFoundError(f"No module named {name!r}", name=name)
        return None


sys.meta_path.insert(0, _Absent())
'''
FASTSVC = {
    "sampling_rate": 16000, "hop_size": 160, "lft_hop_size": 64,
    "shiftms": 10,
    "generator_params": {"in_channels": 80, "mid_channels": [8, 8, 8, 8],
                         "upsampling_scales": [2, 4, 4, 5],
                         "spk_emb_size": 512, "use_spk_emb": True},
    "discriminator_params": {"scales": 2, "channels": 4,
                             "max_downsample_channels": 16,
                             "downsample_scales": [4, 4]},
    "stft_loss_params": {"fft_sizes": [128, 64], "hop_sizes": [32, 16],
                         "win_lengths": [128, 64]},
    "batch_size": 2, "batch_length": 3200,
}
B02 = {
    "sampling_rate": 24000, "hop_size": 160, "shiftms": 6.6666666666,
    "lft_hop_size": 64, "mcep_dim": 59,
    "generator_params": {"input_dim": 80, "output_dim": 60, "hidden_dim": 32,
                         "dec_layers": 2, "multi_speaker": True,
                         "spk_emb_dim": 512, "integrate_logf0": True,
                         "econv_chans": 16, "prenet_dim": 8},
    "discriminator_type": "MultiSubFreqDiscriminator",
    "discriminator_params": {"batch_max_frames": 8},
    "batch_size": 2,
}
# both trainers: steps 1-2 gen_step, 3-4 gan_step, a checkpoint at 4
SCHEDULE = {"discriminator_train_start_steps": 1, "train_max_steps": 4,
            "save_interval_steps": 4, "eval_interval_steps": 4,
            "log_interval_steps": 2, "eval_batches": 1}
VOCODER = {
    "sampling_rate": 24000, "hop_size": 160,
    "signal_generator": {"sine_amp": 0.1, "noise_amp": 0.003,
                         "signal_types": ["sine", "noise"]},
    "aux_context_window": 2, "dense_factor": 4,
    "generator_params": {
        "harmonic_network_params": {"blockA": 2, "cycleA": 1, "blockF": 0,
                                    "cycleF": 0, "cascade_mode": 0},
        "noise_network_params": {"blockA": 0, "cycleA": 0, "blockF": 2,
                                 "cycleF": 2, "cascade_mode": 0},
        "filter_network_params": {"blockA": 0, "cycleA": 0, "blockF": 2,
                                  "cycleF": 1, "cascade_mode": 0},
        "residual_channels": 8, "gate_channels": 16, "skip_channels": 8,
        "aux_channels": 63, "aux_context_window": 2,  # mcep 60 | bap 3
        "upsample_params": {"upsample_scales": [5, 4, 4, 2]},
    },
}
# (split, utterances): two speakers, 0.8-1.3 s each
SPLITS = (("train", 4), ("dev", 2))
RECIPES = ("fastsvc1", "baseline02")
TAG = {"fastsvc1": "fastsvc", "baseline02": "taco2"}


def singing(f0, seconds, sr, seed):
    r = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    inst = f0 * (1 + 0.02 * np.sin(2 * np.pi * 5 * t))
    phase = 2 * np.pi * np.cumsum(inst) / sr
    x = sum(0.5 ** k * np.sin((k + 1) * phase) for k in range(4))
    env = 0.5 * (1 - np.cos(2 * np.pi * np.minimum(t / seconds, 1)))
    return 0.3 * x * env + 0.002 * r.standard_normal(len(t))


def _corpus(root, sr):
    for split, n in SPLITS:
        d = root / "data" / split
        d.mkdir(parents=True)
        lines = []
        for i in range(n):
            spk = "spk" + "AB"[i % 2]
            utt = f"{spk}_{split}{i}"
            path = root / "wav" / f"{utt}.wav"
            path.parent.mkdir(exist_ok=True)
            write_wav(str(path), singing(150.0 if spk == "spkA" else 240.0,
                                         0.8 + 0.1 * i, sr, i), sr)
            lines.append(f"{utt} {path}")
        (d / "wav.scp").write_text("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import torch

    from svcc23_fastsvc_tpu_torch.config import build_vocoder
    from svcc23_fastsvc_tpu_torch.train.checkpoint import (
        save_generator_checkpoint,
    )

    top = tmp_path_factory.mktemp("recipes")
    (top / "absent").mkdir()
    (top / "absent" / "sitecustomize.py").write_text(ABSENT)
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(top / "absent"), REPO])}
    procs = {}
    for recipe, cfg, sr in (("fastsvc1", FASTSVC, 16000),
                            ("baseline02", B02, 24000)):
        root = top / recipe
        _corpus(root, sr)
        (root / "conf.yaml").write_text(yaml.safe_dump({**cfg, **SCHEDULE}))
        argv = ["--conf", "conf.yaml", "--n-jobs", "2", "--device", "cpu",
                "--speakers", "spkB"]
        if recipe == "baseline02":
            (root / "f0_stats.yml").write_text(yaml.safe_dump({
                "spkA": {"lf0_mean": float(np.log(150.0)), "lf0_scale": 0.1},
                "spkB": {"lf0_mean": float(np.log(240.0)),
                         "lf0_scale": 0.1}}))
            voc = build_vocoder(VOCODER,
                                generator=torch.Generator().manual_seed(0))
            save_generator_checkpoint(
                str(root / "voc" / "checkpoint-1steps.pkl"), voc, 1)
            (root / "voc" / "config.yml").write_text(yaml.safe_dump(VOCODER))
            argv += ["--f0-stats", "f0_stats.yml", "--vocoder-dir", "voc"]
        with open(root / "driver.log", "w") as log:
            procs[recipe] = (subprocess.Popen(
                [sys.executable, "-m",
                 f"svcc23_fastsvc_tpu_torch.recipes.{recipe}", *argv],
                cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT,
                start_new_session=True), root)  # its CLIs in its group
    out = {}
    try:
        for recipe, (proc, root) in procs.items():
            rc = proc.wait(timeout=600)
            out[recipe] = (rc, (root / "driver.log").read_text(), root)
    finally:
        for proc, _ in procs.values():  # what a timeout left running
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
    return out


@pytest.mark.parametrize("recipe", RECIPES)
def test_driver_runs_wav_to_converted_wav(runs, recipe):
    rc, log, root = runs[recipe]
    assert rc == 0, log[-4000:]
    stages = json.loads(log.strip().splitlines()[-1].split(" ", 1)[1])
    want = ["0", "1", "2", "3", "4", "5"] + (
        ["7"] if recipe == "baseline02" else [])
    assert list(stages) == want
    assert stages["1"]["processes"] == 4  # train and dev, 2 jobs each
    assert sorted(os.listdir(root / "exp" / "log")) == [
        f"preprocess_{s}.{j}.log" for s in ("dev", "train") for j in (0, 1)]
    # the device CLIs log their kernel launches: none on the CPU
    launches = [json.loads(line.split("kernel launches: ", 1)[1])
                for line in log.splitlines() if "kernel launches: " in line]
    assert len(launches) == (2 if recipe == "fastsvc1" else 3)
    assert all(set(n.values()) == {0} for n in launches)
    wavs = sorted(glob.glob(str(root / "exp" / TAG[recipe] / "wav" / "*.wav")))
    assert len(wavs) == 2  # the dev utterances, each to spkB
    for path in wavs:
        audio, sr = read_wav(path)
        assert sr == (16000 if recipe == "fastsvc1" else 24000)
        assert len(audio) >= 0.7 * sr and np.isfinite(audio).all()


@pytest.mark.parametrize("recipe", RECIPES)
def test_dumps_are_read_by_the_jax_package(runs, recipe):
    rc, log, root = runs[recipe]
    assert rc == 0, log[-4000:]
    files = sorted(glob.glob(str(root / "dump" / "**" / "*.h5"),
                             recursive=True))
    files += sorted(glob.glob(str(root / "exp" / "*" / "decoded" / "*.h5")))
    # 6 utterances, raw and normalised, and the speaker embeddings (B02:
    # and the 2 converted bundles)
    assert len(files) == 13 + (2 if recipe == "baseline02" else 0)
    for path in files:
        port = read_hdf5_all(path)
        assert port
        for name, arr in port.items():
            want = jax_read_hdf5(path, name)
            assert arr.dtype == want.dtype and arr.shape == want.shape
            assert arr.tobytes() == want.tobytes(), (path, name)


@pytest.mark.parametrize("recipe", RECIPES)
def test_stats_are_read_by_the_jax_package(runs, recipe):
    rc, log, root = runs[recipe]
    assert rc == 0, log[-4000:]
    name = "stats.joblib" if recipe == "fastsvc1" else "stats_b02.joblib"
    port = load_scaler(str(root / "dump" / name))
    ref = jax_load_scaler(str(root / "dump" / name))
    pairs = [(port, ref)] if recipe == "fastsvc1" else [
        (port[k], ref[k]) for k in sorted(port)]
    assert recipe == "fastsvc1" or sorted(port) == sorted(ref) == [
        "bap", "lf0", "lft", "mcep", "ppg", "spk_emb"]
    ppg = read_hdf5_all(str(root / "dump" / "train" / "spkA_train0.h5"))
    for got, want in pairs:
        X = np.random.default_rng(0).standard_normal(
            (7, len(got.scale_))) + 1
        np.testing.assert_array_equal(got.transform(X), want.transform(X))
    if recipe == "fastsvc1":
        norm = read_hdf5_all(str(root / "dump" / "train_norm" /
                                 "spkA_train0.h5"))
        np.testing.assert_array_equal(
            norm["ppg"], np.asarray(ref.transform(ppg["ppg"]), np.float32))
