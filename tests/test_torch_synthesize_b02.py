"""The port's B02 vocoder CLI end to end on the CPU, and the CLIs' TF32 rule.

Tiny decoded bundles (hdf5: wave, mcep, bap, f0) and a reference-layout
`.pkl` vocoder checkpoint (weights carried from the JAX package) go through
`svcc23_fastsvc_tpu_torch.bin.synthesize_b02.main --device cpu`; every wav
is held against the port's vocoder and the JAX package's generator on the
same excitation. Every CLI of the port turns TF32 off on entry.
"""

import os
import signal

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from svcc23_fastsvc_tpu.models.hnusfgan import HNUSFGANGenerator as JaxGen
from svcc23_fastsvc_tpu.ops import fold_weight_norm as jax_fold
from svcc23_fastsvc_tpu_torch.bin import (
    decode_fastsvc,
    synthesize_b02,
    train_fastsvc,
)
from svcc23_fastsvc_tpu_torch.compat import hnusfgan_state_dict_from_jax
from svcc23_fastsvc_tpu_torch.config import build_vocoder
from svcc23_fastsvc_tpu_torch.models.fastsvc import FastSVCGenerator
from svcc23_fastsvc_tpu_torch.train.checkpoint import (
    load_vocoder,
    save_generator_checkpoint,
)

SR, HOP = 24000, 160
UTTS = {"spkA_000_to_spkB": 12, "spkA_001_to_spkB": 17}
VOC_CFG = {
    "sampling_rate": SR,
    "hop_size": HOP,
    "signal_generator": {"sine_amp": 0.1, "noise_amp": 0.003,
                         "signal_types": ["sine", "noise"]},
    "aux_context_window": 2,
    "dense_factor": 4,
    "generator_params": {
        "harmonic_network_params": {"blockA": 2, "cycleA": 1, "blockF": 0,
                                    "cycleF": 0, "cascade_mode": 0},
        "noise_network_params": {"blockA": 0, "cycleA": 0, "blockF": 2,
                                 "cycleF": 2, "cascade_mode": 0},
        "filter_network_params": {"blockA": 0, "cycleA": 0, "blockF": 2,
                                  "cycleF": 1, "cascade_mode": 0},
        "residual_channels": 8, "gate_channels": 16, "skip_channels": 8,
        "aux_channels": 10, "aux_context_window": 2,
        "upsample_params": {"upsample_scales": [5, 4, 4, 2]},
    },
}


def _jax_vocoder():
    gp = VOC_CFG["generator_params"]
    return JaxGen(harmonic_params=gp["harmonic_network_params"],
                  noise_params=gp["noise_network_params"],
                  filter_params=gp["filter_network_params"],
                  residual_channels=8, gate_channels=16, skip_channels=8,
                  aux_channels=10, aux_context_window=2,
                  upsample_scales=(5, 4, 4, 2), pd_frame_hop=HOP)


@pytest.fixture(scope="module")
def b02(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_b02")
    r = np.random.default_rng(0)
    dump = root / "decoded"
    dump.mkdir()
    for utt, nf in UTTS.items():
        f0 = np.where(r.random(nf) > 0.25, r.uniform(80, 400, nf), 0.0)
        with h5py.File(dump / f"{utt}.h5", "w") as f:
            f["wave"] = r.standard_normal(nf * HOP).astype(np.float32)
            f["mcep"] = r.standard_normal((nf, 6)).astype(np.float32)
            f["bap"] = r.standard_normal((nf, 4)).astype(np.float32)
            f["f0"] = f0.astype(np.float32)
    jparams = _jax_vocoder().init(jax.random.PRNGKey(9))
    voc = build_vocoder(VOC_CFG)
    voc.load_state_dict(hnusfgan_state_dict_from_jax(
        jax.tree.map(np.asarray, jparams)))
    exp = root / "vocoder"
    save_generator_checkpoint(str(exp / "checkpoint-11steps.pkl"), voc, 11)
    (exp / "config.yml").write_text(yaml.safe_dump(VOC_CFG))
    return root, jparams


def _inputs(root, i, utt):
    """The CLI's inputs for utterance i: its excitation (the CLI's generator
    seed is i), replication-padded aux and dilation factors."""
    from svcc23_fastsvc_tpu_torch.data.dataset import USFGANDataset

    ds = USFGANDataset(str(root / "decoded"), sample_rate=SR, hop_size=HOP)
    name, _, aux, df, f0 = ds[i]
    assert name == utt
    aux = np.concatenate([aux[:1], aux[:1], aux, aux[-1:], aux[-1:]], 0)
    sg = synthesize_b02.signal_generator(VOC_CFG)
    x = sg(torch.from_numpy(f0.astype(np.float32)).reshape(1, -1, 1),
           torch.Generator().manual_seed(i))
    return x, aux.astype(np.float32)[None], df.astype(np.float32)[None]


def test_synthesize_cli_matches_the_vocoder_and_jax(b02, tmp_path):
    root, jparams = b02
    out = tmp_path / "wav"
    synthesize_b02.main([
        "--dumpdir", str(root / "decoded"),
        "--checkpoint", str(root / "vocoder" / "checkpoint-11steps.pkl"),
        "--outdir", str(out), "--device", "cpu", "--verbose", "0"])
    assert sorted(os.listdir(out)) == [f"{u}_gen.wav" for u in sorted(UTTS)]
    voc, steps = load_vocoder(str(root / "vocoder" / "checkpoint-11steps.pkl"),
                              VOC_CFG, device="cpu")
    assert steps == 11
    apply = jax.jit(_jax_vocoder().apply)
    for i, utt in enumerate(sorted(UTTS)):
        sr, pcm = wavfile.read(out / f"{utt}_gen.wav")
        assert sr == SR and pcm.dtype == np.int16
        assert len(pcm) == UTTS[utt] * HOP
        x, aux, df = _inputs(root, i, utt)
        assert x.shape == (1, UTTS[utt] * HOP, 2)
        with torch.no_grad():
            y, _ = voc(x, torch.from_numpy(aux), torch.from_numpy(df))
        y = y[0, :, 0].numpy()
        y_jax, _ = apply(jax_fold(jparams), jnp.asarray(x.numpy()),
                         jnp.asarray(aux), jnp.asarray(df))
        y_jax = np.asarray(y_jax)[0, :, 0]
        scale = np.abs(y_jax).max()
        assert np.abs(y - y_jax).max() <= 1e-5 * scale
        want = np.clip(y, -1.0, 1.0 - 1.0 / 32768)
        np.testing.assert_allclose(pcm / 32768.0, want, rtol=0,
                                   atol=1.0 / 32768 + 1e-6)


def test_synthesize_bf16_on_cpu_is_close_to_f32(b02, tmp_path):
    root, _ = b02
    wavs = {}
    for dt in ("f32", "bf16"):
        out = tmp_path / dt
        synthesize_b02.synthesize_b02(
            str(root / "decoded"),
            str(root / "vocoder" / "checkpoint-11steps.pkl"), str(out),
            infer_dtype=dt, device="cpu")
        wavs[dt] = [wavfile.read(out / f"{u}_gen.wav")[1] / 32768.0
                    for u in sorted(UTTS)]
    for a, b in zip(wavs["f32"], wavs["bf16"]):
        assert np.isfinite(b).all() and a.shape == b.shape
        assert np.abs(a - b).max() <= 5e-2 * np.abs(a).max()


def test_synthesize_targets_cuda_unless_told_otherwise(b02, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root, _ = b02
    with pytest.raises(RuntimeError, match="CUDA"):
        synthesize_b02.main([
            "--dumpdir", str(root / "decoded"),
            "--checkpoint", str(root / "vocoder" / "checkpoint-11steps.pkl"),
            "--outdir", str(tmp_path / "wav"), "--verbose", "0"])


# -- TF32 off in every CLI --------------------------------------------------

GEN = dict(in_channels=8, mid_channels=[16, 8], upsampling_scales=[4, 5],
           spk_emb_size=12, use_spk_emb=True)


@pytest.fixture(scope="module")
def fastsvc(tmp_path_factory):
    """Tiny FastSVC dumps, F0 statistics, speaker embeddings, a generator
    checkpoint and a training config."""
    root = tmp_path_factory.mktemp("torch_cli_tf32")
    r = np.random.default_rng(1)
    dump = root / "dump"
    dump.mkdir()
    for j, nf in enumerate((30, 36)):
        with h5py.File(dump / f"spkA_{j:03d}.h5", "w") as f:
            f["wave"] = (0.1 * r.standard_normal(nf * 20)).astype(np.float32)
            f["f0"] = r.uniform(100, 300, nf).astype(np.float32)
            f["ppg"] = r.standard_normal((nf, 8)).astype(np.float32)
            f["lft"] = r.standard_normal(nf * 20).astype(np.float32)
            f["spk_emb"] = r.standard_normal((1, 12)).astype(np.float32)
    (root / "f0stats").mkdir()
    (root / "f0stats" / "spkA.yml").write_text(
        yaml.safe_dump({"f0_mean": 5.0, "f0_std": 0.3}))
    with h5py.File(root / "spk_embs.h5", "w") as f:
        f["spkA"] = r.standard_normal(12).astype(np.float32)
    cfg = {"sampling_rate": 4000, "hop_size": 20, "generator_params": GEN,
           "signal_generator": {"sine_amp": 0.1, "noise_amp": 0.003,
                                "signal_types": ["sine"]},
           "convert_to_speakers": ["spkA"],
           "discriminator_params": {"scales": 1, "channels": 4,
                                    "max_downsample_channels": 16,
                                    "downsample_scales": [4]},
           "stft_loss_params": {"fft_sizes": [64], "hop_sizes": [16],
                                "win_lengths": [64]},
           "batch_size": 2, "batch_length": 400,
           "train_max_steps": 1, "save_interval_steps": 1,
           "eval_interval_steps": 10, "log_interval_steps": 1}
    (root / "train.yml").write_text(yaml.safe_dump(cfg))
    exp = root / "exp"
    save_generator_checkpoint(str(exp / "checkpoint-1steps.pkl"),
                              FastSVCGenerator(**GEN), 1)
    (exp / "config.yml").write_text(yaml.safe_dump(cfg))
    return root


def _run(cli, b02, fastsvc, tmp_path):
    root = fastsvc
    if cli == "decode_fastsvc":
        decode_fastsvc.main([
            "--dumpdir", str(root / "dump"),
            "--checkpoint", str(root / "exp" / "checkpoint-1steps.pkl"),
            "--outdir", str(tmp_path / "out"),
            "--f0-stats-dir", str(root / "f0stats"),
            "--spk-emb-file", str(root / "spk_embs.h5"),
            "--device", "cpu", "--verbose", "0"])
    elif cli == "train_fastsvc":
        old = signal.getsignal(signal.SIGTERM)
        try:
            train_fastsvc.main([
                "--train-dumpdir", str(root / "dump"),
                "--outdir", str(tmp_path / "exp"),
                "--config", str(root / "train.yml"),
                "--device", "cpu", "--verbose", "0"])
        finally:
            signal.signal(signal.SIGTERM, old)
    else:
        synthesize_b02.main([
            "--dumpdir", str(b02[0] / "decoded"),
            "--checkpoint",
            str(b02[0] / "vocoder" / "checkpoint-11steps.pkl"),
            "--outdir", str(tmp_path / "out"), "--device", "cpu",
            "--verbose", "0"])
    assert os.listdir(tmp_path / ("exp" if cli == "train_fastsvc" else "out"))


@pytest.mark.parametrize("cli", ["decode_fastsvc", "train_fastsvc",
                                 "synthesize_b02"])
def test_cli_turns_tf32_off(cli, b02, fastsvc, tmp_path):
    """... and only the training CLI sets cuDNN's deterministic algorithms."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    saved_det = torch.backends.cudnn.deterministic
    try:
        for f in flags:
            f.allow_tf32 = True
        torch.backends.cudnn.deterministic = False
        _run(cli, b02, fastsvc, tmp_path)
        assert [f.allow_tf32 for f in flags] == [False, False]
        assert torch.backends.cudnn.deterministic == (cli == "train_fastsvc")
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v
        torch.backends.cudnn.deterministic = saved_det


def test_vocoder_config_needs_no_fastsvc_defaults(b02):
    root, _ = b02
    cfg = synthesize_b02.read_config(str(root / "vocoder" / "config.yml"))
    assert cfg == VOC_CFG
    # B02's excitation is sine | noise where the config names none
    bare = {k: v for k, v in cfg.items() if k != "signal_generator"}
    assert synthesize_b02.signal_generator(bare).signal_types == \
        ("sine", "noise")
    voc = build_vocoder(cfg)
    assert voc.harmonic_network.pd_frame_hop == HOP
    assert len(voc.filter_network.conv_dilated) == 2
