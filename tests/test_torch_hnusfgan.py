"""The port's HN-uSFGAN vocoder and its inputs against the JAX package.

The whole generator at tests/test_hnusfgan_parity.py's widths (2 adaptive,
2 noise and 3 filter blocks, R 8, G 16, aux 10, scales 4 x 5) with
frame-constant dilation factors and with per-sample ones, the weight bridge
in both directions, the
excitation's "uv" and "noise" channels, `dilated_factor` and
`USFGANDataset`; inputs are made with numpy from a seed.
"""

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svcc23_fastsvc_tpu.compat import convert_hnusfgan
from svcc23_fastsvc_tpu.data.dataset import USFGANDataset as JaxUSFGANDataset
from svcc23_fastsvc_tpu.dsp.f0 import dilated_factor as jax_dilated_factor
from svcc23_fastsvc_tpu.models.hnusfgan import HNUSFGANGenerator as JaxGen
from svcc23_fastsvc_tpu.ops import fold_weight_norm as jax_fold
from svcc23_fastsvc_tpu.ops.signal_gen import SignalGenerator as JaxSigGen
from svcc23_fastsvc_tpu_torch.compat import hnusfgan_state_dict_from_jax
from svcc23_fastsvc_tpu_torch.data.dataset import USFGANDataset
from svcc23_fastsvc_tpu_torch.dsp.f0 import dilated_factor
from svcc23_fastsvc_tpu_torch.models.hnusfgan import HNUSFGANGenerator
from svcc23_fastsvc_tpu_torch.ops import pd_block
from svcc23_fastsvc_tpu_torch.ops.signal_gen import SignalGenerator

HOP = 20
NETS = dict(
    harmonic_params=dict(blockA=2, cycleA=2, blockF=0, cycleF=0,
                         cascade_mode=0),
    noise_params=dict(blockA=0, cycleA=0, blockF=2, cycleF=2, cascade_mode=0),
    filter_params=dict(blockA=0, cycleA=0, blockF=3, cycleF=3,
                       cascade_mode=0),
)
WIDTHS = dict(residual_channels=8, gate_channels=16, skip_channels=8,
              aux_channels=10, aux_context_window=2, upsample_scales=(4, 5))


def _jax_model(hop=HOP):
    return JaxGen(**NETS, **WIDTHS, pd_frame_hop=hop)


def _port_model(folded, hop=HOP):
    port = HNUSFGANGenerator(**NETS, **WIDTHS, pd_frame_hop=hop,
                             use_weight_norm=True)
    port.load_state_dict(hnusfgan_state_dict_from_jax(
        jax.tree.map(np.asarray, _jax_model().init(jax.random.PRNGKey(5)))))
    return port.fold_weight_norm_() if folded else port


def _inputs(seed=0, B=2, Tf=20):
    r = np.random.default_rng(seed)
    T = Tf * HOP
    x = (r.standard_normal((B, T, 2)) * 0.1).astype(np.float32)
    c = r.standard_normal((B, Tf + 4, 10)).astype(np.float32)
    f0 = np.where(r.random((B, Tf)) > 0.2, r.uniform(80, 400, (B, Tf)), 0.0)
    d = np.stack([np.repeat(dilated_factor(f, 8000, 4), HOP) for f in f0])
    return x, c, d.astype(np.float32)


@pytest.fixture(scope="module")
def jax_outputs():
    """The JAX generator's (y, source) in f32 and bf16, with weight norm
    live and folded."""
    params = _jax_model().init(jax.random.PRNGKey(5))
    x, c, d = _inputs()
    apply = jax.jit(_jax_model().apply)
    out = {}
    for folded in (False, True):
        p = jax_fold(params) if folded else params
        for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
            pd = jax.tree.map(lambda v: v.astype(dt), p)
            y, s = apply(pd, jnp.asarray(x, dt), jnp.asarray(c, dt),
                         jnp.asarray(d))
            out[folded, name] = (np.asarray(y, np.float32),
                                 np.asarray(s, np.float32))
    return out


def _port(folded, dtype):
    x, c, d = _inputs()
    model = _port_model(folded).to(dtype)
    before = (pd_block.pd_adaptive_block.launches,
              pd_block.pd_fixed_block.launches)
    with torch.no_grad():
        y, s = model(torch.from_numpy(x).to(dtype),
                     torch.from_numpy(c).to(dtype), torch.from_numpy(d))
    # the wrappers take their plain versions on the CPU: nothing launches
    assert (pd_block.pd_adaptive_block.launches,
            pd_block.pd_fixed_block.launches) == before
    return y.float().numpy(), s.float().numpy()


@pytest.mark.parametrize("folded", [False, True])
def test_generator_f32_matches_jax(jax_outputs, folded):
    """With weight norm live or folded the blocks run the kernels' plain
    versions on the effective weights: both equal the JAX XLA path."""
    got = _port(folded, torch.float32)
    for g, w in zip(got, jax_outputs[folded, "f32"]):
        assert g.shape == w.shape == (2, 20 * HOP, 1)
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()


@pytest.mark.parametrize("folded", [False, True])
def test_generator_bf16_matches_jax_as_a_whole(jax_outputs, folded):
    """bf16 rounds at other places in the two (the kernels' plain versions
    sum in f32, JAX's XLA path in bf16): each is held to JAX's bf16 by
    relative L2, within twice JAX bf16's own distance from f32 and 3e-2."""
    got = _port(folded, torch.bfloat16)
    for g, w, w32 in zip(got, jax_outputs[folded, "bf16"],
                         jax_outputs[folded, "f32"]):
        assert np.isfinite(g).all()
        own = np.linalg.norm(w - w32) / np.linalg.norm(w32)
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= max(2 * own, 3e-2), (rel, own)


@pytest.mark.parametrize("folded", [False, True])
def test_generator_per_sample_dilation_matches_jax(folded):
    """With no frame hop (or T % hop != 0) the adaptive blocks gather per
    sample, as the JAX package does, on dilation factors that vary within
    a frame."""
    x, c, _ = _inputs()
    r = np.random.default_rng(9)
    d = r.uniform(1.0, 40.0, x.shape[:2]).astype(np.float32)
    params = _jax_model(hop=0).init(jax.random.PRNGKey(5))
    if folded:
        params = jax_fold(params)
    want = jax.jit(_jax_model(hop=0).apply)(params, jnp.asarray(x),
                                            jnp.asarray(c), jnp.asarray(d))
    model = _port_model(folded, hop=0)
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in (x, c, d)))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape == (2, 20 * HOP, 1)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


@pytest.mark.parametrize("folded", [False, True])
def test_state_dict_round_trips_through_convert_hnusfgan(folded):
    params = _jax_model().init(jax.random.PRNGKey(2))
    if folded:
        params = jax_fold(params)
    params = jax.tree.map(np.asarray, params)
    sd = hnusfgan_state_dict_from_jax(params)
    port = HNUSFGANGenerator(**NETS, **WIDTHS, use_weight_norm=not folded)
    port.load_state_dict(sd)  # strict: the keys are the port's own
    back = convert_hnusfgan(port.state_dict(), n_up_scales=2)
    want, tree = jax.tree.flatten(params)
    got, tree2 = jax.tree.flatten(jax.tree.map(np.asarray, back))
    assert tree == tree2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_signal_generator_uv_and_noise():
    r = np.random.default_rng(4)
    f0 = np.where(r.random((2, 50, 1)) > 0.3, r.uniform(80, 400, (2, 50, 1)),
                  0.0).astype(np.float32)
    kw = dict(sample_rate=8000, hop_size=40, noise_amp=0.003)
    sg = SignalGenerator(signal_types=("sine", "noise", "uv"), **kw)
    out = sg(torch.from_numpy(f0), torch.Generator().manual_seed(0))
    assert out.shape == (2, 2000, 3) and out.dtype == torch.float32
    want_uv = JaxSigGen(signal_types=("uv",), use_pallas=False, **kw)(
        jnp.asarray(f0))
    np.testing.assert_array_equal(out[..., 2:].numpy(), np.asarray(want_uv))
    # the sine channel is the sine-only generator's, drawn first
    sine = SignalGenerator(**kw)(torch.from_numpy(f0),
                             torch.Generator().manual_seed(0))
    assert torch.equal(out[..., :1], sine)
    noise = out[..., 1].numpy().ravel()
    assert abs(noise.mean()) < 0.05 and abs(noise.std() - 1.0) < 0.05
    with pytest.raises(ValueError):
        SignalGenerator(signal_types=("sine", "pulse"))


def test_dilated_factor_matches_jax():
    r = np.random.default_rng(6)
    f0 = np.where(r.random(300) > 0.3, r.uniform(40, 800, 300), 0.0)
    for fs, dense in ((24000, 4), (16000, 2)):
        got = dilated_factor(f0, fs, dense)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, jax_dilated_factor(f0, fs, dense))


def test_usfgan_dataset_matches_jax(tmp_path):
    r = np.random.default_rng(7)
    # frame counts of f0, mcep and bap and the wave length disagree, as in
    # real dumps: both datasets trim them the same way
    for name, nf, nm, nw in (("utt_a", 40, 42, 40 * 160 + 37),
                             ("utt_b", 33, 33, 30 * 160 + 5)):
        f0 = np.where(r.random(nf) > 0.2, r.uniform(80, 400, nf), 0.0)
        with h5py.File(tmp_path / f"{name}.h5", "w") as f:
            f["wave"] = r.standard_normal(nw).astype(np.float32)
            f["mcep"] = r.standard_normal((nm, 40)).astype(np.float32)
            f["bap"] = r.standard_normal((nm, 22)).astype(np.float32)
            f["f0"] = f0.astype(np.float32)
    port = USFGANDataset(str(tmp_path), sample_rate=24000, hop_size=160)
    ref = JaxUSFGANDataset(str(tmp_path), sample_rate=24000, hop_size=160,
                           return_utt_id=True)
    assert len(port) == len(ref) == 2
    for i in range(2):
        got, want = port[i], ref[i]
        assert got[0] == want[0]
        for g, w in zip(got[1:], want[1:]):
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
