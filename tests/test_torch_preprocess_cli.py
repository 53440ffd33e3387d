"""The recipe's stages 0-3 through the port's CLIs and the JAX CLIs.

Synthetic wavs (16 and 24 kHz, two speakers) go through speaker
embeddings (hash mode), feature extraction (Harvest F0, loudness, log-mel
linguistic features), F0 statistics, the PPG scaler and normalisation: the
port's CLIs run with `--device cpu` in a fresh interpreter that never
imports JAX or the JAX package, and then convert the normalised dumps with
the port's `decode_fastsvc` (a random-init checkpoint); the JAX CLIs run
in-process on the same wavs. Every dataset of every dump, the F0 yaml files
and the normalised PPGs are compared. The conformer linguistic path (and
YIN) goes through both packages' `extract_features` with a 2-block
reference-layout `.pth` that both `load_ppg_model`s read, at a 24 kHz
config, where the PPG is stretched x1.5.
"""

import os
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch
import yaml

from svcc23_fastsvc_tpu.bin import compute_f0stats as j_f0stats
from svcc23_fastsvc_tpu.bin import compute_statistics_fastsvc as j_stats
from svcc23_fastsvc_tpu.bin import extract_spk_embs as j_embs
from svcc23_fastsvc_tpu.bin import normalize_fastsvc as j_norm
from svcc23_fastsvc_tpu.bin import preprocess_fastsvc as j_pre
from svcc23_fastsvc_tpu.bin.common import write_wav
from svcc23_fastsvc_tpu.models.conformer_ppg import (
    load_ppg_model as j_load_ppg,
)
from svcc23_fastsvc_tpu_torch.bin import normalize_fastsvc as t_norm
from svcc23_fastsvc_tpu_torch.bin import preprocess_fastsvc as t_pre
from svcc23_fastsvc_tpu_torch.models import conformer_ppg as tppg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOP = 160
# (utterance, sample rate, f0, seconds)
UTTS = [("spkA_000", 16000, 140.0, 1.1), ("spkA_001", 24000, 155.0, 0.9),
        ("spkB_000", 16000, 230.0, 1.0), ("spkB_001", 16000, 250.0, 0.8)]
CONFIG = {
    "sampling_rate": 16000, "hop_size": HOP, "lft_hop_size": 64,
    "shiftms": 10,
    "generator_params": {"in_channels": 80, "mid_channels": [8, 8, 8, 8],
                         "upsampling_scales": [2, 4, 4, 5],
                         "spk_emb_size": 16, "use_spk_emb": True},
    "convert_to_speakers": ["spkB"],
}
F0_RANGES = {"spkA": {"minf0": 80.0, "maxf0": 300.0},
             "spkB": {"minf0": 120.0, "maxf0": 420.0}}
# log-mel of f32 spectra from two FFT libraries, absolute in nepers (the
# quiet bins' logs differ most); the normalised PPG likewise, its std
# being above 1; loudness as in test_torch_frontend
TOL_LOG, TOL_LFT = 1e-3, 1e-4


def singing(f0, seconds, sr, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    inst = f0 * (1 + 0.02 * np.sin(2 * np.pi * 5 * t))
    phase = 2 * np.pi * np.cumsum(inst) / sr
    x = sum(0.5 ** k * np.sin((k + 1) * phase) for k in range(4))
    env = 0.5 * (1 - np.cos(2 * np.pi * np.minimum(t / seconds, 1)))
    return (0.3 * x * env + 0.002 * rng.standard_normal(len(t)))


PORT_PIPELINE = r"""
import os, shutil, sys
import torch
from svcc23_fastsvc_tpu_torch.bin import (compute_f0stats,
    compute_statistics_fastsvc, decode_fastsvc, extract_spk_embs,
    normalize_fastsvc, preprocess_fastsvc)
from svcc23_fastsvc_tpu_torch.config import build_generator, load_config
from svcc23_fastsvc_tpu_torch.train.checkpoint import save_generator_checkpoint

root = sys.argv[1]
out = os.path.join(root, "port")
q = ["--verbose", "0"]
extract_spk_embs.main(["--wav-scp", f"{root}/wav.scp", "--out-file",
                       f"{out}/spk_embs.h5", "--mode", "hash", "--dim", "16"]
                      + q)
preprocess_fastsvc.main(["--wav-scp", f"{root}/wav.scp", "--dumpdir",
                         f"{out}/raw", "--config", f"{root}/config.yml",
                         "--f0-config", f"{root}/f0.yml", "--spk-emb-file",
                         f"{out}/spk_embs.h5", "--device", "cpu"] + q)
compute_f0stats.main(["--dumpdir", f"{out}/raw", "--outdir",
                      f"{out}/f0_stats"] + q)
compute_statistics_fastsvc.main(["--dumpdir", f"{out}/raw", "--dumpfile",
                                 f"{out}/stats.joblib"] + q)
normalize_fastsvc.main(["--dumpdir", f"{out}/raw", "--outdir",
                        f"{out}/norm", "--stats", f"{out}/stats.joblib"] + q)
cfg = load_config(f"{root}/config.yml")
gen = build_generator(cfg, generator=torch.Generator().manual_seed(0))
save_generator_checkpoint(f"{out}/exp/checkpoint-1steps.pkl", gen, 1)
shutil.copy(f"{root}/config.yml", f"{out}/exp/config.yml")
decode_fastsvc.main(["--dumpdir", f"{out}/norm", "--checkpoint",
                     f"{out}/exp/checkpoint-1steps.pkl", "--outdir",
                     f"{out}/wav", "--f0-stats-dir", f"{out}/f0_stats",
                     "--spk-emb-file", f"{out}/spk_embs.h5",
                     "--device", "cpu"] + q)
print(sorted(m for m in sys.modules if m == "svcc23_fastsvc_tpu"
             or m.startswith(("svcc23_fastsvc_tpu.", "jax"))))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("frontend_cli")
    lines = []
    for i, (utt, sr, f0, sec) in enumerate(UTTS):
        path = root / f"{utt}.wav"
        write_wav(str(path), singing(f0, sec, sr, i), sr)
        lines.append(f"{utt} {path}")
    (root / "wav.scp").write_text("\n".join(lines) + "\n")
    (root / "config.yml").write_text(yaml.safe_dump(CONFIG))
    (root / "f0.yml").write_text(yaml.safe_dump(F0_RANGES))

    port = subprocess.run(
        [sys.executable, "-c", PORT_PIPELINE, str(root)], cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})
    assert port.returncode == 0, port.stderr[-4000:]

    jx = root / "jax"
    j_embs.main(["--wav-scp", str(root / "wav.scp"), "--out-file",
                 str(jx / "spk_embs.h5"), "--mode", "hash", "--dim", "16",
                 "--verbose", "0"])
    argv = sys.argv
    sys.argv = ["preprocess", "--wav-scp", str(root / "wav.scp"),
                "--dumpdir", str(jx / "raw"), "--config",
                str(root / "config.yml"), "--f0-config", str(root / "f0.yml"),
                "--spk-emb-file", str(jx / "spk_embs.h5"), "--verbose", "0"]
    try:
        j_pre.main()
    finally:
        sys.argv = argv
    j_f0stats.compute_f0stats(str(jx / "raw"), str(jx / "f0_stats"))
    j_stats.compute_statistics(str(jx / "raw"), str(jx / "stats.joblib"))
    j_norm.normalize(str(jx / "raw"), str(jx / "norm"),
                     str(jx / "stats.joblib"))
    return root, port.stdout


def _read(path):
    with h5py.File(path, "r") as f:
        return {k: f[k][()] for k in f}


def test_port_side_never_imports_jax(runs):
    _, stdout = runs
    assert stdout.strip().splitlines()[-1] == "[]"


def test_speaker_embeddings_equal(runs):
    root, _ = runs
    port, ref = _read(root / "port" / "spk_embs.h5"), _read(
        root / "jax" / "spk_embs.h5")
    assert sorted(port) == sorted(ref) == ["spkA", "spkB"]
    for spk in ref:
        assert port[spk].shape == (1, 16) and port[spk].dtype == np.float32
        np.testing.assert_array_equal(port[spk], ref[spk])


@pytest.mark.parametrize("utt", [u[0] for u in UTTS])
def test_dumps_match(runs, utt):
    root, _ = runs
    port = _read(root / "port" / "raw" / f"{utt}.h5")
    ref = _read(root / "jax" / "raw" / f"{utt}.h5")
    assert sorted(port) == sorted(ref) == ["f0", "lft", "ppg", "spk_emb",
                                           "wave"]
    for name in ref:
        assert port[name].shape == ref[name].shape, name
        assert port[name].dtype == ref[name].dtype == np.float32, name
    # host work: resampling, Harvest, the embedding lookup, bit for bit
    for name in ("wave", "f0", "spk_emb"):
        np.testing.assert_array_equal(port[name], ref[name], err_msg=name)
    assert (ref["f0"] > 0).mean() > 0.5
    np.testing.assert_allclose(port["ppg"], ref["ppg"], rtol=0, atol=TOL_LOG)
    np.testing.assert_allclose(port["lft"], ref["lft"], rtol=0, atol=TOL_LFT)


def test_f0_stats_equal(runs):
    root, _ = runs
    for spk in ("spkA", "spkB"):
        port = yaml.safe_load((root / "port" / "f0_stats" / f"{spk}.yml")
                              .read_text())
        ref = yaml.safe_load((root / "jax" / "f0_stats" / f"{spk}.yml")
                             .read_text())
        assert port == ref


@pytest.mark.parametrize("utt", [u[0] for u in UTTS])
def test_normalized_ppgs_match(runs, utt):
    root, _ = runs
    port = _read(root / "port" / "norm" / f"{utt}.h5")
    ref = _read(root / "jax" / "norm" / f"{utt}.h5")
    assert sorted(port) == sorted(ref)
    for name in ("wave", "f0", "lft", "spk_emb"):
        np.testing.assert_array_equal(
            port[name], _read(root / "port" / "raw" / f"{utt}.h5")[name])
    np.testing.assert_allclose(port["ppg"], ref["ppg"], rtol=0, atol=TOL_LOG)


def test_port_normalize_reads_the_jax_stats(runs, tmp_path):
    root, _ = runs
    t_norm.normalize(str(root / "jax" / "raw"), str(tmp_path),
                     str(root / "jax" / "stats.joblib"))
    for utt, *_ in UTTS:
        np.testing.assert_array_equal(
            _read(tmp_path / f"{utt}.h5")["ppg"],
            _read(root / "jax" / "norm" / f"{utt}.h5")["ppg"])


def test_port_decode_converts_the_port_dumps(runs):
    root, _ = runs
    wavs = sorted(os.listdir(root / "port" / "wav"))
    assert wavs == [f"{u[0]}_to_spkB.wav" for u in UTTS]
    from scipy.io import wavfile

    for (utt, *_), name in zip(UTTS, wavs):
        sr, pcm = wavfile.read(root / "port" / "wav" / name)
        frames = len(_read(root / "port" / "norm" / f"{utt}.h5")["f0"])
        assert sr == 16000 and len(pcm) == frames * HOP
        assert np.abs(pcm).max() > 0


def test_conformer_and_yin_features_match_jax(tmp_path):
    torch.manual_seed(0)
    path = str(tmp_path / "ppg.pth")
    torch.save(tppg.ConformerPPG(num_blocks=2).state_dict(), path)
    cfg = {"sampling_rate": 24000, "hop_size": 240, "lft_hop_size": 96,
           "shiftms": 10, "f0_method": "yin"}
    audio = singing(180.0, 1.2, 24000, 7)
    kw = dict(f0min=80.0, f0max=400.0, linguistic="conformer")
    port = t_pre.extract_features(
        "spkA_000", audio, 24000, cfg, device="cpu",
        ppg_model=tppg.load_ppg_model(path, num_blocks=2, device="cpu"),
        **kw)
    ref = j_pre.extract_features("spkA_000", audio, 24000, cfg,
                                 ppg_model=j_load_ppg(path, num_blocks=2),
                                 **kw)
    n = len(ref["f0"])
    assert port["ppg"].shape == ref["ppg"].shape == (n, 144)
    assert len(port["wave"]) == len(port["lft"]) == n * 240
    np.testing.assert_array_equal(port["wave"], ref["wave"])
    np.testing.assert_array_equal(port["f0"] > 0, ref["f0"] > 0)
    np.testing.assert_allclose(port["f0"], ref["f0"], rtol=1e-4)
    np.testing.assert_allclose(port["lft"], ref["lft"], rtol=0, atol=TOL_LFT)
    np.testing.assert_allclose(port["ppg"], ref["ppg"], rtol=0,
                               atol=1e-4 * np.abs(ref["ppg"]).max())


def test_clis_refuse_cuda_without_a_gpu(runs, monkeypatch):
    root, _ = runs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_pre.main(["--wav-scp", str(root / "wav.scp"), "--dumpdir",
                    str(root / "never"), "--config", str(root / "config.yml")])
    with pytest.raises(RuntimeError, match="CUDA"):
        tppg.load_ppg_model(str(root / "no.pth"))
    assert not (root / "never").exists()
