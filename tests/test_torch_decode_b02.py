"""The port's B02 acoustic-model decode CLI (`bin/decode_b02.py`) on the
CPU, and the B02 conversion chained through `bin/synthesize_b02.py`.

Tiny B02 dumps (hdf5 in B02Dataset's layout), a reference-layout `.pkl`
Tacotron2 checkpoint (weights carried from the JAX package, under the
reference wrapper's "acoustic_network." prefix, with a postnet entry that
the forward never calls) and its config go through
`decode_b02.main --device cpu`: the bundles hold the keys and shapes the
JAX CLI writes, the semitone-shifted F0, and the model's output on the
CLI's prenet masks. The bundles then go through the vocoder CLI to wavs.
"""

import os

import h5py
import jax
import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from svcc23_fastsvc_tpu.bin.decode_b02 import semitone_shift as jax_shift
from svcc23_fastsvc_tpu.models.tacotron2 import Tacotron2 as JaxT2
from svcc23_fastsvc_tpu_torch.bin import decode_b02, synthesize_b02
from svcc23_fastsvc_tpu_torch.compat import tacotron2_state_dict_from_jax
from svcc23_fastsvc_tpu_torch.config import build_vocoder
from svcc23_fastsvc_tpu_torch.data.dataset import B02Dataset
from svcc23_fastsvc_tpu_torch.train.checkpoint import (
    load_acoustic_model,
    save_generator_checkpoint,
)

GP = dict(input_dim=16, output_dim=60, hidden_dim=32, dec_layers=2,
          multi_speaker=True, spk_emb_dim=8, integrate_logf0=True,
          econv_chans=16, prenet_dim=8)
UTTS = {"spkA_000": 14, "spkA_001": 9}
MAX_FRAMES = 20
F0_STATS = {"spkA": {"lf0_mean": float(np.log(150.0)), "lf0_scale": 0.1},
            "spkB": {"lf0_mean": float(np.log(240.0)), "lf0_scale": 0.1}}
SR, HOP = 24000, 120
VOC_CFG = {
    "sampling_rate": SR,
    "hop_size": HOP,
    "signal_generator": {"sine_amp": 0.1, "noise_amp": 0.003,
                         "signal_types": ["sine", "noise"]},
    "aux_context_window": 2,
    "dense_factor": 4,
    "generator_params": {
        "harmonic_network_params": {"blockA": 1, "cycleA": 1, "blockF": 0,
                                    "cycleF": 0, "cascade_mode": 0},
        "noise_network_params": {"blockA": 0, "cycleA": 0, "blockF": 1,
                                 "cycleF": 1, "cascade_mode": 0},
        "filter_network_params": {"blockA": 0, "cycleA": 0, "blockF": 1,
                                  "cycleF": 1, "cascade_mode": 0},
        "residual_channels": 8, "gate_channels": 16, "skip_channels": 8,
        "aux_channels": 63, "aux_context_window": 2,
        "upsample_params": {"upsample_scales": [5, 4, 3, 2]},
    },
}


def test_semitone_shift_equals_jax():
    for src in np.log([80.0, 131.0, 150.0, 220.0, 440.0]):
        for tgt in np.log([82.4, 150.0, 240.0, 330.0, 523.2]):
            assert decode_b02.semitone_shift(src, tgt) == jax_shift(src, tgt)
    assert decode_b02.semitone_shift(np.log(150.0), np.log(240.0)) == 8


@pytest.fixture(scope="module")
def b02(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_decode_b02")
    r = np.random.default_rng(0)
    dump = root / "dump"
    dump.mkdir()
    for utt, nf in UTTS.items():
        with h5py.File(dump / f"{utt}.h5", "w") as f:
            f["wave"] = (0.1 * r.standard_normal(nf * HOP)).astype(np.float32)
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
    (root / "f0_stats.yml").write_text(yaml.safe_dump(F0_STATS))
    exp = root / "exp"
    exp.mkdir()
    params = JaxT2(**GP).init(jax.random.PRNGKey(4))
    sd = tacotron2_state_dict_from_jax(jax.tree.map(np.asarray, params))
    sd = {f"acoustic_network.{k}": v for k, v in sd.items()}
    sd["acoustic_network.postnet.postnet.0.0.weight"] = torch.zeros(3)
    torch.save({"model": {"generator": sd}, "steps": 7},
               exp / "checkpoint-7steps.pkl")
    (exp / "config.yml").write_text(yaml.safe_dump(
        {"generator_params": GP, "sampling_rate": SR, "hop_size": HOP}))
    voc = root / "vocoder"
    save_generator_checkpoint(str(voc / "checkpoint-3steps.pkl"),
                              build_vocoder(VOC_CFG, generator=torch.Generator()
                                            .manual_seed(1)), 3)
    (voc / "config.yml").write_text(yaml.safe_dump(VOC_CFG))
    return root


def _decode(root, out, *extra):
    decode_b02.main([
        "--dumpdir", str(root / "dump"),
        "--checkpoint", str(root / "exp" / "checkpoint-7steps.pkl"),
        "--outdir", str(out), "--spk-emb-file", str(root / "spk_embs.h5"),
        "--f0-stats", str(root / "f0_stats.yml"), "--speakers", "spkB",
        "--max-frames", str(MAX_FRAMES), "--device", "cpu", "--verbose", "0",
        *extra])


def test_cli_writes_the_jax_bundles(b02, tmp_path):
    out = tmp_path / "decoded"
    _decode(b02, out)
    assert sorted(os.listdir(out)) == [f"{u}_spkB.h5" for u in sorted(UTTS)]
    cfg = yaml.safe_load((b02 / "exp" / "config.yml").read_text())
    model, steps = load_acoustic_model(
        str(b02 / "exp" / "checkpoint-7steps.pkl"), cfg, device="cpu")
    assert steps == 7 and next(model.parameters()).dtype == torch.float32
    ds = B02Dataset(str(b02 / "dump"))
    rng = torch.Generator().manual_seed(0)  # the CLI's prenet masks
    ratio = 2.0 ** (8 / 12)  # 150 -> 240 Hz: 8 semitones
    emb = torch.from_numpy(np.asarray(
        h5py.File(b02 / "spk_embs.h5")["spkB"], np.float32)[None])
    for i, utt in enumerate(sorted(UTTS)):
        name, wave, f0, ppg, lft, lf0, *_ = ds[i]
        assert name == utt
        L = UTTS[utt]
        with h5py.File(out / f"{utt}_spkB.h5") as f:
            got = {k: f[k][()] for k in f}
        # the JAX CLI's keys and shapes (svcc23_fastsvc_tpu/bin/decode_b02.py)
        assert {k: v.shape for k, v in got.items()} == {
            "mcep": (L, 60), "bap": (L, 3), "lf0": (L, 1), "lft": (L, 1),
            "ppg": (L, 16), "f0": (L, 1), "wave": (L * HOP,)}
        np.testing.assert_allclose(got["f0"][:, 0], f0 * ratio, rtol=1e-6)
        np.testing.assert_allclose(got["lf0"], lf0 * ratio, rtol=1e-6)
        np.testing.assert_array_equal(got["ppg"], ppg)
        np.testing.assert_array_equal(got["wave"], wave)
        pad = [np.zeros((1, MAX_FRAMES, a.shape[-1]), np.float32)
               for a in (ppg, lft, lf0)]
        for p, a in zip(pad, (ppg, lft, lf0 * ratio)):
            p[0, :L] = a
        want = decode_b02.decode_batch(
            model, torch.from_numpy(pad[0]), torch.tensor([L]),
            torch.from_numpy(pad[1]), torch.from_numpy(pad[2]), emb,
            generator_rng=rng)[0, :L].numpy()
        np.testing.assert_allclose(np.concatenate([got["mcep"], got["bap"]],
                                                  1), want, rtol=1e-5,
                                   atol=1e-5)


def test_cli_decodes_in_the_configs_dtype_and_turns_tf32_off(b02, tmp_path):
    """compute_dtype bfloat16 in the config (the recipe's taco2.yaml) makes
    a bf16 decode; the flag wins over it; TF32 is off after the CLI."""
    cfg = yaml.safe_load((b02 / "exp" / "config.yml").read_text())
    cfg_path = tmp_path / "bf16.yml"
    cfg_path.write_text(yaml.safe_dump({**cfg, "compute_dtype": "bfloat16"}))
    outs = {}
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        for name, extra in (("bf16", ()), ("f32", ("--infer-dtype", "f32"))):
            _decode(b02, tmp_path / name, "--config", str(cfg_path), *extra)
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            with h5py.File(tmp_path / name / "spkA_000_spkB.h5") as f:
                outs[name] = f["mcep"][()]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    f32_ref = tmp_path / "default"
    _decode(b02, f32_ref)
    with h5py.File(f32_ref / "spkA_000_spkB.h5") as f:
        np.testing.assert_array_equal(outs["f32"], f["mcep"][()])
    diff = np.abs(outs["bf16"] - outs["f32"]).max()
    assert np.isfinite(outs["bf16"]).all()
    assert 0 < diff <= 5e-2 * np.abs(outs["f32"]).max()


def test_cli_targets_cuda_unless_told_otherwise(b02, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        decode_b02.decode_b02(
            str(b02 / "dump"), str(b02 / "exp" / "checkpoint-7steps.pkl"),
            str(tmp_path), spk_emb_file=str(b02 / "spk_embs.h5"),
            f0_stats=F0_STATS, speakers=["spkB"])


def test_decoded_bundles_vocode_to_wavs(b02, tmp_path):
    """Stage 5 then stage 7: the decoded mcep | bap and shifted F0 through
    the vocoder CLI."""
    decoded = tmp_path / "decoded"
    _decode(b02, decoded)
    wav = tmp_path / "wav"
    synthesize_b02.main([
        "--dumpdir", str(decoded),
        "--checkpoint", str(b02 / "vocoder" / "checkpoint-3steps.pkl"),
        "--outdir", str(wav), "--device", "cpu", "--verbose", "0"])
    assert sorted(os.listdir(wav)) == [f"{u}_spkB_gen.wav"
                                       for u in sorted(UTTS)]
    for utt, nf in UTTS.items():
        sr, pcm = wavfile.read(wav / f"{utt}_spkB_gen.wav")
        assert sr == SR and pcm.dtype == np.int16 and len(pcm) == nf * HOP
        assert np.abs(pcm).max() > 0
