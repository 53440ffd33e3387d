"""The port's x-vector extractor against the JAX package on the CPU.

SpeechBrain's widths (24 mels, TDNN 512 x 4 + 1500, 512-d embedding).
Weights go both ways: JAX `init` params (every leaf given noise from a
numpy seed, batch-norm variances drawn in [0.5, 1.5]) carried into the
port by `xvector_state_dict_from_jax`, and a SpeechBrain-layout state dict
saved as `embedding_model.ckpt` that both packages' `load_xvector_model`
read. Audio is 1-2 s made from a numpy seed; embeddings agree to 1e-4 of
their largest value (f32).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svcc23_fastsvc_tpu.models import xvector as jxv
from svcc23_fastsvc_tpu_torch.compat import xvector_state_dict_from_jax
from svcc23_fastsvc_tpu_torch.models import xvector as txv

TOL = 1e-4


def _rng(seed=0):
    return np.random.default_rng(seed)


def wavs(n=2, seconds=1.3, seed=1):
    rng = _rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    return np.stack([
        0.3 * np.sin(2 * np.pi * (120 + 60 * i) * t * (1 + 0.1 * t))
        + 0.05 * rng.standard_normal(len(t)) for i in range(n)
    ]).astype(np.float32)


def _close(got, want, tol=TOL):
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def test_fbank_and_sentence_norm_match_jax():
    x = wavs()
    want = np.asarray(jxv.sentence_norm(jxv.fbank_features(jnp.asarray(x))))
    got = txv.sentence_norm(txv.fbank_features(torch.from_numpy(x))).numpy()
    assert got.shape == (2, x.shape[1] // 160 + 1, 24)
    # log-fbank in dB from f32 spectra: within 1e-3 dB
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_jax_params_carry_into_the_port():
    rng = _rng(2)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape)
                   ).astype(np.float32),
        jxv.XVector().init(jax.random.PRNGKey(0)))
    for blk in params["blocks"]:
        blk["bn"]["var"] = rng.uniform(0.5, 1.5, blk["bn"]["var"].shape
                                       ).astype(np.float32)
    x = wavs()
    want = np.asarray(jax.jit(jxv.XVector().encode)(params, jnp.asarray(x)))
    model = txv.XVector()
    model.load_state_dict(xvector_state_dict_from_jax(params))
    with torch.no_grad():
        got = model.eval().encode(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 512)
    _close(got, want)


def test_speechbrain_state_dict_loads_in_both_packages(tmp_path):
    torch.manual_seed(0)
    sd = txv.XVector().state_dict()
    gen = torch.Generator().manual_seed(1)
    for k, v in sd.items():
        if k.endswith("running_mean"):
            v.copy_(0.2 * torch.randn(v.shape, generator=gen))
        elif k.endswith("running_var"):
            v.copy_(torch.rand(v.shape, generator=gen) + 0.5)
    assert {"blocks.0.conv.weight", "blocks.2.norm.running_var",
            "blocks.14.norm.weight", "blocks.16.w.weight"} <= set(sd)
    path = str(tmp_path / "embedding_model.ckpt")
    torch.save(sd, path)
    x = wavs(n=1, seconds=1.8, seed=3)[0]
    port = txv.load_xvector_model(path, device="cpu")
    assert not port.training
    with torch.no_grad():
        got = port.encode(torch.from_numpy(x))[0].numpy()
    want = np.asarray(jxv.load_xvector_model(path)(jnp.asarray(x)))
    _close(got, want)


def test_statistics_pooling_is_the_population_std():
    h = torch.from_numpy(_rng(4).standard_normal((2, 3, 7)))
    got = txv.StatisticsPooling()(h)
    np.testing.assert_allclose(got[:, 3:].numpy(),
                               np.std(h.numpy(), axis=-1), rtol=1e-12)


def test_loaders_refuse_cuda_without_a_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "x.ckpt")
    torch.save(txv.XVector().state_dict(), path)
    with pytest.raises(RuntimeError, match="CUDA"):
        txv.load_xvector_model(path)
