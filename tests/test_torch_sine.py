"""PyTorch port's sine excitation and signal generator against the JAX package.

The plain sine is held against the TPU kernel (`sine_excitation` in
interpret mode) and the JAX `SignalGenerator.sinusoid` with no noise, at
the JAX test's 2e-4. The CUDA kernel is held against the plain version in
tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svcc23_fastsvc_tpu.ops.pallas_kernels import sine_excitation as jax_sine
from svcc23_fastsvc_tpu.ops.signal_gen import SignalGenerator as JaxSigGen
from svcc23_fastsvc_tpu.ops.signal_gen import continuous_f0 as jax_contf0
from svcc23_fastsvc_tpu_torch.ops.signal_gen import (
    SignalGenerator,
    continuous_f0,
)
from svcc23_fastsvc_tpu_torch.ops.sine import sine_excitation

HOP, FS = 160, 16000


def _f0(B, Tf, seed=7):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((B, Tf)) > 0.3, rng.uniform(80, 300, (B, Tf)),
                    0.0).astype(np.float32)


@pytest.mark.parametrize("Tf", [100, 77])
def test_plain_sine_matches_tpu_kernel_and_signal_generator(Tf):
    f0 = _f0(3, Tf)
    got = sine_excitation(torch.from_numpy(f0), hop=HOP, sr=FS, amp=0.1).numpy()
    kern = np.asarray(jax_sine(jnp.asarray(f0), hop=HOP, sr=FS, amp=0.1,
                               interpret=True))
    gen = JaxSigGen(sample_rate=FS, hop_size=HOP, sine_amp=0.1, noise_amp=0.0,
                    use_pallas=False)
    want = np.asarray(gen.sinusoid(jnp.asarray(f0)[:, :, None],
                                   jax.random.PRNGKey(0)))[:, :, 0]
    np.testing.assert_allclose(got, kern, atol=2e-4)
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_continuous_f0_matches_jax():
    f0 = np.zeros((3, 8, 1), np.float32)
    f0[0, :, 0] = [0, 0, 100, 0, 0, 200, 0, 0]
    f0[1, :, 0] = [120, 0, 0, 0, 0, 0, 0, 150]
    f0[2] = _f0(1, 8, seed=3).T
    got = continuous_f0(torch.from_numpy(f0)).numpy()
    want = np.asarray(jax_contf0(jnp.asarray(f0)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.all(continuous_f0(torch.zeros(1, 5, 1)).numpy() == 0)


@pytest.mark.parametrize("sine_f0_type", ["f0", "contf0"])
def test_signal_generator_matches_jax_without_noise(sine_f0_type):
    f0 = _f0(2, 40, seed=11)[:, :, None]
    kw = dict(sample_rate=FS, hop_size=HOP, sine_amp=0.1, noise_amp=0.0,
              sine_f0_type=sine_f0_type)
    sg = SignalGenerator(**kw)
    jsg = JaxSigGen(**kw, use_pallas=False)
    got = sg(torch.from_numpy(f0)).numpy()
    want = np.asarray(jsg(jnp.asarray(f0), jax.random.PRNGKey(0)))
    assert got.shape == want.shape == (2, 40 * HOP, 1)
    np.testing.assert_allclose(got, want, atol=2e-4)
    np.testing.assert_array_equal(sg.vuv_binary(torch.from_numpy(f0)).numpy(),
                                  np.asarray(jsg.vuv_binary(jnp.asarray(f0))))


def test_signal_generator_takes_only_the_sine_type():
    # "noise" and "uv" are ported too (the B02 vocoder's excitation); a type
    # the JAX package lacks is refused
    with pytest.raises(ValueError):
        SignalGenerator(signal_types=("sine", "pulse"))
    assert SignalGenerator(signal_types=("sine", "uv")).signal_types == (
        "sine", "uv")


def test_signal_generator_noise_follows_the_torch_generator():
    f0 = torch.from_numpy(_f0(2, 10, seed=5)[:, :, None])
    sg = SignalGenerator(hop_size=HOP)
    a = sg(f0, torch.Generator().manual_seed(3))
    b = sg(f0, torch.Generator().manual_seed(3))
    c = sg(f0, torch.Generator().manual_seed(4))
    assert a.shape == (2, 10 * HOP, 1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # the noise floor is V/UV-gated: unvoiced samples carry a third of it
    clean = SignalGenerator(hop_size=HOP, noise_amp=0.0)(f0)
    resid = (a - clean).abs()
    vuv = sg.vuv_binary(f0) > 0
    assert resid[~vuv].max() < resid[vuv].max()
