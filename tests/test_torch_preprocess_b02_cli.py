"""The B02 recipe's stages 0-3, `split_train_dev` and `evaluate` through
the port's CLIs and the JAX CLIs.

Synthetic singing (16 and 24 kHz, two speakers) at taco2.yaml's settings
(24 kHz, hop 160, shiftms 6.6666666666, mcep_dim 59, Harvest) goes through
speaker embeddings (hash mode), `preprocess_b02` (log-mel linguistic
features), `compute_statistics_b02` and `normalize_b02`; a wav.scp through
`split_train_dev`; the wavs against perturbed copies through `evaluate`.
The port's CLIs run with `--device cpu` in one fresh interpreter that must
not import JAX or the JAX package; the JAX CLIs run in-process on the same
files. Every dataset of every raw and normalised dump is compared: host
work (resampling, Harvest, continuous log-F0, V/UV, the embedding lookup)
bit for bit, log-mel and loudness as in test_torch_preprocess_cli, mcep
and bap (raw and normalised) against the JAX module's WORLD analysis in
f64 of the same frames (the port computes WORLD in f64, the JAX CLI in
f32, whose dumps are held at their measured distance). The HuBERT path
(and YIN) goes through both packages' `extract_b02_features` with a small in-process model.
"""

import json
import os
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch
import yaml

import jax

from svcc23_fastsvc_tpu.bin import compute_statistics_b02 as j_stats
from svcc23_fastsvc_tpu.bin import evaluate as j_eval
from svcc23_fastsvc_tpu.bin import extract_spk_embs as j_embs
from svcc23_fastsvc_tpu.bin import normalize_b02 as j_norm
from svcc23_fastsvc_tpu.bin import preprocess_b02 as j_pre
from svcc23_fastsvc_tpu.bin import split_train_dev as j_split
from svcc23_fastsvc_tpu.bin.common import read_wav as j_read_wav
from svcc23_fastsvc_tpu.bin.common import resample as j_resample
from svcc23_fastsvc_tpu.bin.common import write_wav
from svcc23_fastsvc_tpu.dsp.harvest import harvest_f0 as j_harvest_f0
from svcc23_fastsvc_tpu.models import hubert as jh
from svcc23_fastsvc_tpu_torch.bin import normalize_b02 as t_norm
from svcc23_fastsvc_tpu_torch.bin import preprocess_b02 as t_pre
from svcc23_fastsvc_tpu_torch.models import hubert as th
from svcc23_fastsvc_tpu_torch.utils.scalers import StandardScaler, load_scaler
from test_torch_world import hold, jax_world64

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR, HOP, SHIFTMS = 24000, 160, 6.6666666666
# (utterance, sample rate, f0, seconds)
UTTS = [("spkA_000", 24000, 150.0, 0.9), ("spkA_001", 16000, 165.0, 0.8),
        ("spkB_000", 24000, 240.0, 0.85), ("spkB_001", 24000, 260.0, 0.7)]
CONFIG = {"sampling_rate": SR, "hop_size": HOP, "shiftms": SHIFTMS,
          "mcep_dim": 59, "lft_hop_size": 64}
F0_RANGES = {"spkA": {"minf0": 80.0, "maxf0": 400.0},
             "spkB": {"minf0": 120.0, "maxf0": 600.0}}
# log-mel in nepers and loudness, as test_torch_preprocess_cli; evaluate's
# mel L1 and MCD relative
TOL_LOG, TOL_LFT, TOL_EVAL = 1e-3, 1e-4, 1e-3
# mcep and bap, each of max |y|, against the JAX module's analysis in f64
# of the same frames, rounded to f32 (the world64 fixture). Measured, raw:
# mcep 4.6e-5 on the utterance resampled from 16 kHz (its empty band above
# 8 kHz leaves the smoothing integral's f64 round-off, which differs
# between two f64 implementations, in the log envelope), at most 7.3e-9 on
# the others, bap 0; normalised: mcep 1.2e-3 (the high-order
# coefficients' small deviations magnify it), bap 4.5e-8.
TOL_WORLD = {"mcep": 1e-4, "bap": 1e-6}
TOL_WORLD_NORM = {"mcep": 5e-3, "bap": 1e-6}
# The JAX CLI computes WORLD in f32, the port in f64: the JAX dumps lie
# this far from the same f64 analysis, and so from the port's (measured,
# raw: mcep 0.275, bap 2.6e-4; normalised: mcep 1.35, bap 2.1e-4)
DIVERGE = {"mcep": 0.35, "bap": 5e-4}
DIVERGE_NORM = {"mcep": 1.7, "bap": 5e-4}
WORLD = ("mcep", "bap")


def singing(f0, seconds, sr, seed):
    r = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    inst = f0 * (1 + 0.02 * np.sin(2 * np.pi * 5 * t))
    phase = 2 * np.pi * np.cumsum(inst) / sr
    x = sum(0.5 ** k * np.sin((k + 1) * phase) for k in range(4))
    env = 0.5 * (1 - np.cos(2 * np.pi * np.minimum(t / seconds, 1)))
    return 0.3 * x * env + 0.002 * r.standard_normal(len(t))


PORT_PIPELINE = r"""
import json, os, sys
import torch
torch.cos(torch.zeros(1 << 20))  # see test_torch_world: the first op's race
from svcc23_fastsvc_tpu_torch.bin import (compute_statistics_b02, evaluate,
    extract_spk_embs, normalize_b02, preprocess_b02, split_train_dev)

root = sys.argv[1]
out = os.path.join(root, "port")
q = ["--verbose", "0"]
extract_spk_embs.main(["--wav-scp", f"{root}/wav.scp", "--out-file",
                       f"{out}/spk_embs.h5", "--mode", "hash", "--dim", "16"]
                      + q)
preprocess_b02.main(["--wav-scp", f"{root}/wav.scp", "--dumpdir",
                     f"{out}/raw", "--config", f"{root}/config.yml",
                     "--f0-config", f"{root}/f0.yml", "--spk-emb-file",
                     f"{out}/spk_embs.h5", "--linguistic", "logmel",
                     "--device", "cpu"] + q)
compute_statistics_b02.main(["--dumpdir", f"{out}/raw", "--dumpfile",
                             f"{out}/stats.joblib"] + q)
normalize_b02.main(["--dumpdir", f"{out}/raw", "--outdir", f"{out}/norm",
                    "--stats", f"{out}/stats.joblib"] + q)
split_train_dev.main(["--source-scp", f"{root}/all.scp", "--train-scp-out",
                      f"{out}/train.scp", "--dev-scp-out", f"{out}/dev.scp",
                      "--dev-count", "2"])
evaluate.main(["--ref-dir", f"{root}/ref", "--hyp-dir", f"{root}/hyp",
               "--device", "cpu"] + q)
print(sorted(m for m in sys.modules if m == "svcc23_fastsvc_tpu"
             or m.startswith(("svcc23_fastsvc_tpu.", "jax"))))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("b02_cli")
    lines = []
    (root / "ref").mkdir()
    (root / "hyp").mkdir()
    for i, (utt, sr, f0, sec) in enumerate(UTTS):
        x = singing(f0, sec, sr, i)
        path = root / "ref" / f"{utt}.wav"
        write_wav(str(path), x, sr)
        lines.append(f"{utt} {path}")
        # a converted stand-in: shifted up 2 % with more noise, 24 kHz
        y = j_resample(singing(f0 * 1.02, sec, sr, 10 + i), sr, SR)
        write_wav(str(root / "hyp" / f"{utt}_gen.wav"), 0.9 * y, SR)
    (root / "wav.scp").write_text("\n".join(lines) + "\n")
    (root / "all.scp").write_text(
        "\n".join(f"spk{s}_{j:03d} /data/spk{s}_{j:03d}.wav"
                  for j in range(4) for s in "CAB") + "\nbroken-line\n\n")
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
    j_pre.main(["--wav-scp", str(root / "wav.scp"), "--dumpdir",
                str(jx / "raw"), "--config", str(root / "config.yml"),
                "--f0-config", str(root / "f0.yml"), "--spk-emb-file",
                str(jx / "spk_embs.h5"), "--linguistic", "logmel",
                "--verbose", "0"])
    j_stats.compute_statistics_b02(str(jx / "raw"), str(jx / "stats.joblib"))
    j_norm.normalize_b02(str(jx / "raw"), str(jx / "norm"),
                         str(jx / "stats.joblib"))
    j_split.split_wav_scp(str(root / "all.scp"), str(jx / "train.scp"),
                          str(jx / "dev.scp"), 2)
    evaluated = j_eval.evaluate_dirs(str(root / "ref"), str(root / "hyp"))
    return root, port.stdout, evaluated


@pytest.fixture(scope="module")
def world64(runs):
    """Each utterance's mcep and bap by the JAX module's analysis in f64
    on the JAX CLI's signal and F0, rounded to the dumps' f32, and the
    same normalised by scalers fitted over them. Every utterance is
    zero-padded to the longest, its F0 with unvoiced frames, so that JAX
    compiles once: a frame reads zeros past the signal's end either way,
    and the padded frames are dropped."""
    root, _, _ = runs
    inputs = {}
    for utt, sr, _, _ in UTTS:
        audio, wsr = j_read_wav(str(root / "ref" / f"{utt}.wav"))
        audio = j_resample(audio, wsr, SR)
        rng = F0_RANGES[utt.split("_")[0]]
        f0 = j_harvest_f0(audio, fs=SR, f0_floor=rng["minf0"],
                          f0_ceil=rng["maxf0"], frame_period_ms=SHIFTMS)
        inputs[utt] = (np.asarray(audio, np.float32), f0.astype(np.float32))
    T = max(len(x) for x, _ in inputs.values())
    F = max(len(f0) for _, f0 in inputs.values())
    out = {}
    for utt, (audio, f0) in inputs.items():
        mcep, bap = jax_world64(np.pad(audio, (0, T - len(audio))),
                                np.pad(f0, (0, F - len(f0))), fs=SR,
                                hop=int(SR * SHIFTMS / 1000))
        n = len(_read(root / "jax" / "raw" / f"{utt}.h5")["f0"])
        out[utt] = {"mcep": mcep[:n].astype(np.float32),
                    "bap": bap[:n].astype(np.float32)}
    for k in WORLD:
        scaler = StandardScaler()
        for f in out.values():
            scaler.partial_fit(f[k])
        for f in out.values():
            f[f"{k} norm"] = scaler.transform(f[k])
    return out


def hold_world(port, ref, yardstick, suffix, tol, diverge):
    """The port's mcep and bap within `tol` of the JAX module's f64
    analysis, and their distance from the JAX CLI's f32 dumps (JAX's own
    f32 round-off) within `diverge`, each of max |y|."""
    for name in WORLD:
        want = yardstick[name + suffix]
        e_port = hold(port[name], want, tol[name], f"{name}{suffix}")
        e_jax = hold(ref[name], want, diverge[name], f"jax {name}{suffix}")
        hold(port[name], ref[name], diverge[name], f"port-jax {name}{suffix}")
        assert e_port < e_jax, (f"{name}{suffix}", e_port, e_jax)


def _read(path):
    with h5py.File(path, "r") as f:
        return {k: f[k][()] for k in f}


def test_port_side_never_imports_jax(runs):
    _, stdout, _ = runs
    assert stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("utt", [u[0] for u in UTTS])
def test_raw_dumps_match(runs, world64, utt):
    root, _, _ = runs
    port = _read(root / "port" / "raw" / f"{utt}.h5")
    ref = _read(root / "jax" / "raw" / f"{utt}.h5")
    assert sorted(port) == sorted(ref) == [
        "bap", "f0", "lf0", "lft", "mcep", "ppg", "spk_emb", "vuv", "wave"]
    n = len(ref["f0"])
    for name in ref:
        assert port[name].shape == ref[name].shape, name
        assert port[name].dtype == ref[name].dtype == np.float32, name
    assert port["mcep"].shape == (n, 60) and port["bap"].shape == (n, 3)
    assert port["ppg"].shape == (n, 80) and port["lft"].shape == (n, 1)
    # host work bit for bit
    for name in ("wave", "f0", "lf0", "vuv", "spk_emb"):
        np.testing.assert_array_equal(port[name], ref[name], err_msg=name)
    assert (ref["vuv"] > 0).mean() > 0.5
    np.testing.assert_allclose(port["ppg"], ref["ppg"], rtol=0, atol=TOL_LOG)
    np.testing.assert_allclose(port["lft"], ref["lft"], rtol=0, atol=TOL_LFT)
    hold_world(port, ref, world64[utt], "", TOL_WORLD, DIVERGE)


def test_stats_match_and_cross_load(runs):
    root, _, _ = runs
    port = load_scaler(str(root / "port" / "stats.joblib"))
    ref = load_scaler(str(root / "jax" / "stats.joblib"))
    from svcc23_fastsvc_tpu.utils.scalers import load_scaler as j_load

    jax_reads_port = j_load(str(root / "port" / "stats.joblib"))
    assert sorted(port) == sorted(ref) == sorted(jax_reads_port) == [
        "bap", "lf0", "lft", "mcep", "ppg", "spk_emb"]
    for k in ("lf0", "spk_emb"):
        np.testing.assert_array_equal(port[k].data_min_, ref[k].data_min_)
        np.testing.assert_array_equal(port[k].data_max_, ref[k].data_max_)
    for k, tol in (("ppg", TOL_LOG), ("lft", TOL_LFT)):
        np.testing.assert_allclose(port[k].data_min_, ref[k].data_min_,
                                   rtol=0, atol=tol)
        np.testing.assert_allclose(port[k].data_max_, ref[k].data_max_,
                                   rtol=0, atol=tol)
    for k in WORLD:
        assert port[k].n_samples_seen_ == ref[k].n_samples_seen_
        np.testing.assert_array_equal(jax_reads_port[k].mean_, port[k].mean_)


@pytest.mark.parametrize("utt", [u[0] for u in UTTS])
def test_normalized_dumps_match(runs, world64, utt):
    root, _, _ = runs
    port = _read(root / "port" / "norm" / f"{utt}.h5")
    ref = _read(root / "jax" / "norm" / f"{utt}.h5")
    raw = _read(root / "port" / "raw" / f"{utt}.h5")
    assert sorted(port) == sorted(ref) == [
        "bap", "f0", "lf0", "lft", "mcep", "ppg", "spk_emb", "vuv", "wave"]
    for name in ref:
        assert port[name].shape == ref[name].shape, name
        assert port[name].dtype == ref[name].dtype == np.float32, name
    for name in ("wave", "f0", "vuv"):
        np.testing.assert_array_equal(port[name], raw[name])
    for name in ("lf0", "spk_emb"):
        np.testing.assert_array_equal(port[name], ref[name], err_msg=name)
    # min-max to [0, 1] of a log-mel and a loudness within their tolerance
    scale = load_scaler(str(root / "jax" / "stats.joblib"))
    np.testing.assert_allclose(
        port["ppg"], ref["ppg"], rtol=0,
        atol=2 * TOL_LOG * np.max(scale["ppg"].scale_))
    np.testing.assert_allclose(port["lft"], ref["lft"], rtol=0,
                               atol=2 * TOL_LFT * scale["lft"].scale_[0])
    hold_world(port, ref, world64[utt], " norm", TOL_WORLD_NORM,
               DIVERGE_NORM)


def test_port_normalize_reads_the_jax_stats(runs, tmp_path):
    root, _, _ = runs
    t_norm.normalize_b02(str(root / "jax" / "raw"), str(tmp_path),
                         str(root / "jax" / "stats.joblib"))
    for utt, *_ in UTTS:
        got, want = (_read(tmp_path / f"{utt}.h5"),
                     _read(root / "jax" / "norm" / f"{utt}.h5"))
        assert sorted(got) == sorted(want)
        for name in want:
            np.testing.assert_array_equal(got[name], want[name])


def test_split_train_dev_identical(runs):
    root, stdout, _ = runs
    for name in ("train.scp", "dev.scp"):
        assert (root / "port" / name).read_text() == (
            root / "jax" / name).read_text()
    dev = (root / "port" / "dev.scp").read_text().splitlines()
    assert len(dev) == 6 and {ln[:4] for ln in dev} == {"spkA", "spkB",
                                                         "spkC"}
    assert "split 6 dev utts over 3 speakers (1 invalid lines skipped)" in (
        stdout)


def test_evaluate_json_matches_jax(runs):
    _, stdout, ref = runs
    got = json.loads(next(ln for ln in stdout.splitlines()
                          if ln.startswith("{")))
    assert sorted(got) == sorted(ref) == [
        "mcd_mean", "mel_l1_mean", "n_pairs", "per_utt", "per_utt_mcd"]
    assert got["n_pairs"] == ref["n_pairs"] == len(UTTS)
    assert sorted(got["per_utt"]) == sorted(ref["per_utt"])
    for key in ("mel_l1_mean", "mcd_mean"):
        np.testing.assert_allclose(got[key], ref[key], rtol=TOL_EVAL)
        assert got[key] > 0
    for key in ("per_utt", "per_utt_mcd"):
        for utt, v in ref[key].items():
            np.testing.assert_allclose(got[key][utt], v, rtol=TOL_EVAL)


def test_hubert_and_yin_features_match_jax(tmp_path):
    """The HuBERT linguistic path through both packages'
    `extract_b02_features`: a small model in bshall's layout read by the
    port's loader and JAX's converter, at 24 kHz (units stretched x1.5),
    with YIN on the device."""
    small = dict(d_model=96, n_layers=2, n_heads=4, ff_dim=192, conv_dim=64,
                 unit_dim=32)
    torch.manual_seed(0)
    model = th.HubertSoft(**small)
    path = str(tmp_path / "hubert-soft.pt")
    torch.save(th.bshall_checkpoint(model), path)
    port_model = th.HubertSoft(**small).eval()
    port_model.load_state_dict(th.hubert_state_dict(
        torch.load(path, weights_only=True)))
    params = jh.convert_hubert_state_dict(
        torch.load(path, map_location="cpu")["hubert"], jh.HubertSoft(**small))
    jax_fwd = jax.jit(lambda w: jh.HubertSoft(**small).apply(params, w)[0])
    cfg = {**CONFIG, "f0_method": "yin"}
    audio = singing(200.0, 1.0, 16000, 7)
    kw = dict(f0min=80.0, f0max=500.0, linguistic="hubert")
    port = t_pre.extract_b02_features("spkA_000", audio, 16000, cfg,
                                      ppg_model=port_model, device="cpu",
                                      **kw)
    ref = j_pre.extract_b02_features("spkA_000", audio, 16000, cfg,
                                     ppg_model=jax_fwd, **kw)
    n = len(ref["f0"])
    assert port["ppg"].shape == ref["ppg"].shape == (n, 32)
    np.testing.assert_array_equal(port["wave"], ref["wave"])
    np.testing.assert_array_equal(port["vuv"], ref["vuv"])
    np.testing.assert_allclose(port["f0"], ref["f0"], rtol=1e-4)
    np.testing.assert_allclose(port["ppg"], ref["ppg"], rtol=0,
                               atol=1e-4 * np.abs(ref["ppg"]).max())
    with pytest.raises(ValueError, match="hubert-checkpoint"):
        t_pre.extract_b02_features("spkA_000", audio, 16000, cfg,
                                   f0min=80.0, f0max=500.0,
                                   linguistic="hubert", device="cpu")


def test_clis_refuse_cuda_without_a_gpu(runs, monkeypatch):
    root, _, _ = runs
    from svcc23_fastsvc_tpu_torch.bin import evaluate as t_eval

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_pre.main(["--wav-scp", str(root / "wav.scp"), "--dumpdir",
                    str(root / "never"), "--config", str(root / "config.yml")])
    with pytest.raises(RuntimeError, match="CUDA"):
        t_eval.evaluate_dirs(str(root / "ref"), str(root / "hyp"))
    assert not (root / "never").exists()
