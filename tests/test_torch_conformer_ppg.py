"""The port's conformer PPG extractor against the JAX package on the CPU.

Two blocks at the reference width (144-d, 4 heads, k 15). Weights go both
ways: JAX `init` params (every leaf perturbed from a numpy seed, so that
biases and batch-norm statistics are not their trivial values) carried
into the port by `conformer_ppg_state_dict_from_jax`, and a reference-
layout state dict saved as a `.pth` that both packages' `load_ppg_model`
read. Audio is 1-2 s made from a numpy seed; outputs agree to 1e-4 of
their largest value (f32, two libraries' FFTs and matmuls through two
conformer blocks).
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svcc23_fastsvc_tpu.models import conformer_ppg as jppg
from svcc23_fastsvc_tpu_torch.compat import conformer_ppg_state_dict_from_jax
from svcc23_fastsvc_tpu_torch.models import conformer_ppg as tppg

BLOCKS = 2
TOL = 1e-4


def _rng(seed=0):
    return np.random.default_rng(seed)


def _perturbed(params, seed=0):
    """Every leaf of a JAX param tree as numpy, moved off its init value:
    noise of std 0.1 added (zero biases, LN and BN parameters included),
    BN variances drawn from [0.5, 1.5]."""
    rng = _rng(seed)

    def walk(p, key=""):
        if isinstance(p, dict):
            return {k: walk(v, k) for k, v in p.items()}
        if isinstance(p, list):
            return [walk(v, key) for v in p]
        a = np.asarray(p, np.float32)
        if key == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    return walk(params)


@lru_cache(maxsize=None)
def jax_params():
    return _perturbed(jppg.ConformerPPG(num_blocks=BLOCKS).init(
        jax.random.PRNGKey(0)))


@lru_cache(maxsize=None)
def jax_apply():
    model = jppg.ConformerPPG(num_blocks=BLOCKS)
    return jax.jit(model.apply)


def port_from_jax():
    model = tppg.ConformerPPG(num_blocks=BLOCKS)
    model.load_state_dict(conformer_ppg_state_dict_from_jax(jax_params()))
    return model.eval()


def speech(n=2, seconds=(1.5, 1.5), seed=1):
    rng = _rng(seed)
    T = int(max(seconds) * 16000)
    x = np.zeros((n, T), np.float32)
    for i, s in enumerate(seconds):
        t = np.arange(int(s * 16000)) / 16000
        x[i, :len(t)] = (0.3 * np.sin(2 * np.pi * (150 + 40 * i) * t)
                         + 0.05 * rng.standard_normal(len(t)))
    return x


def _close(got, want, tol=TOL):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def test_frontend_and_mvn_match_jax():
    x = speech()
    want = np.asarray(jppg.utterance_mvn(jppg.frontend_logmel(jnp.asarray(x))))
    got = tppg.utterance_mvn(tppg.frontend_logmel(torch.from_numpy(x)))
    _close(got.numpy(), want, 1e-5)
    # the var ** 0.25 quirk and the other branches of utterance_mvn
    f = _rng(2).standard_normal((2, 50, 8)).astype(np.float32) * 3 + 1
    for kw in (dict(norm_vars=False), dict(norm_means=False)):
        _close(tppg.utterance_mvn(torch.from_numpy(f), **kw).numpy(),
               np.asarray(jppg.utterance_mvn(jnp.asarray(f), **kw)), 1e-6)


def test_jax_params_carry_into_the_port():
    # JAX's rel_mha reshapes the position table with x's batch size, so
    # JAX runs one utterance a call; the port runs both in one batch
    x = speech()
    want = np.concatenate([np.asarray(jax_apply()(jax_params(),
                                                  jnp.asarray(x[i:i + 1])))
                           for i in range(2)])
    with torch.no_grad():
        got = port_from_jax()(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 1.5 * 16000 // 160 + 1, 144)
    _close(got, want)


def test_mask_path_matches_jax():
    # 0.7 s of speech padded to 1.2 s: attention's keys past the speech
    # are masked
    x = speech(n=1, seconds=(0.7,), seed=3)
    x = np.pad(x, ((0, 0), (0, int(0.5 * 16000))))
    T = x.shape[1] // 160 + 1
    mask = (np.arange(T) < 0.7 * 16000 // 160 + 1)[None]
    want = np.asarray(jax_apply()(jax_params(), jnp.asarray(x),
                                  jnp.asarray(mask)))
    with torch.no_grad():
        got = port_from_jax()(torch.from_numpy(x),
                              torch.from_numpy(mask)).numpy()
    _close(got, want)
    with torch.no_grad():
        unmasked = port_from_jax()(torch.from_numpy(x)).numpy()
    assert np.abs(unmasked - got).max() > 1e-3


def test_reference_state_dict_loads_in_both_packages(tmp_path):
    torch.manual_seed(0)
    ref = tppg.ConformerPPG(num_blocks=BLOCKS)
    sd = ref.state_dict()
    gen = torch.Generator().manual_seed(1)
    for k, v in sd.items():  # batch norm's statistics off 0 / 1
        if k.endswith("running_mean"):
            v.copy_(0.2 * torch.randn(v.shape, generator=gen))
        elif k.endswith("running_var"):
            v.copy_(torch.rand(v.shape, generator=gen) + 0.5)
    # the reference checkpoint also holds modules the extractor drops
    full = {**sd, "ctc.ctc_lo.weight": torch.zeros(3, 144),
            "frontend.logmel.melmat": torch.zeros(513, 80)}
    path = str(tmp_path / "24epoch.pth")
    torch.save(full, path)
    x = speech(n=1, seconds=(1.0,), seed=4)[0]
    port = tppg.load_ppg_model(path, num_blocks=BLOCKS, device="cpu")
    assert not port.training
    with torch.no_grad():
        got = port(torch.from_numpy(x))[0].numpy()
    want = np.asarray(jppg.load_ppg_model(path, num_blocks=BLOCKS)(
        jnp.asarray(x)))
    _close(got, want)
    # bare encoder keys, without num_batches_tracked, load the same model
    bare = {k[len("encoder."):]: v for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}
    model = tppg.ConformerPPG(num_blocks=BLOCKS)
    tppg.load_reference_state(model, tppg.encoder_state_dict(bare))
    with torch.no_grad():
        np.testing.assert_array_equal(
            model.eval()(torch.from_numpy(x))[0].numpy(), got)
    with pytest.raises(KeyError, match="missing"):
        tppg.load_reference_state(tppg.ConformerPPG(num_blocks=BLOCKS + 1),
                                  sd)


def test_position_table_past_5000_frames():
    T = 5003
    np.testing.assert_array_equal(
        tppg.rel_positional_encoding(T, 144).numpy(),
        np.asarray(jppg.rel_positional_encoding(T, 144)))
    # one narrow block over 5003 frames of features, against JAX's encode
    small = dict(input_size=4, attention_dim=8, attention_heads=2,
                 linear_units=8, num_blocks=1, cnn_module_kernel=3)
    jmodel = jppg.ConformerPPG(**small)
    params = _perturbed(jmodel.init(jax.random.PRNGKey(1)), seed=5)
    feats = _rng(6).standard_normal((1, T, 4)).astype(np.float32)
    want = np.asarray(jax.jit(jmodel.encode)(params, jnp.asarray(feats)))
    port = tppg.ConformerPPG(**small)
    port.load_state_dict(conformer_ppg_state_dict_from_jax(params))
    with torch.no_grad():
        got = port.eval().encode(torch.from_numpy(feats)).numpy()
    _close(got, want)
