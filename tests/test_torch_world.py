"""The port's WORLD analysis (dsp/world.py) against the JAX package on the
CPU.

0.3 s of 24 kHz singing made from a numpy seed: six harmonics with
vibrato, a 62.5 ms pause (unvoiced frames, F0 0) and noise, frames 159
samples apart (taco2.yaml's WORLD hop). The yardstick is the JAX module
itself in f64 (its functions follow the input's dtype under
`jax.enable_x64`), on the same f32-rounded signal. Tolerances, each of the
largest |y| of the JAX f64 result:
  * the port in f64 (the pipeline's compute dtype) within 1e-7 of it
    (measured at most 5.3e-10: log envelope 4.1e-10, bap 2.0e-13, D4C
    5.3e-10, mcep 3.9e-11);
  * the port in f32 within 2e-4 (measured: bap 7.0e-5, log envelope
    8.9e-6, D4C 8.9e-6, mcep 1.3e-6). JAX's own f32 is far from its f64
    where the smoothing integral loses the quiet bins (log envelope 2.2,
    D4C 0.39, mcep 0.097; bap 8.3e-5), so the port is held to JAX's
    function in f64, not to its f32 round-off;
  * `world_analyze` (f64 compute, f32 out) within 1e-6, its f32 rounding;
  * freqt's matrix form within 1e-6 of max |y| of JAX's f32 scan and of
    an f64 recursion, its f64 matrix within 1e-13;
  * the host helpers and continuous log-F0 equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svcc23_fastsvc_tpu.dsp import world as jw
from svcc23_fastsvc_tpu_torch.bin import preprocess_b02 as t_pre
from svcc23_fastsvc_tpu_torch.dsp import world as tw

# torch's CPU build can compute a fresh process's first transcendental op
# with ~1.5e-4 error on one thread's chunk (a race); one op clears it
torch.cos(torch.zeros(1 << 20))

FS, HOP = 24000, 159
SECONDS = 0.3
TOL_F64, TOL_F32, TOL_OUT = 1e-7, 2e-4, 1e-6


def signal(seed=0):
    r = np.random.default_rng(seed)
    T = int(SECONDS * FS)
    t = np.arange(T) / FS
    f0c = 220.0 * (1 + 0.03 * np.sin(2 * np.pi * 5 * t))
    phase = 2 * np.pi * np.cumsum(f0c) / FS
    x = 0.3 * sum(0.5 ** k * np.sin((k + 1) * phase) for k in range(6))
    pause = (t >= 0.15) & (t < 0.2125)
    x[pause] = 0.0
    x = x + 0.003 * r.standard_normal(T)
    F = T // HOP + 1
    pos = np.arange(F) * HOP
    f0 = np.interp(pos, np.arange(T), f0c).astype(np.float32)
    f0[(pos >= 0.15 * FS) & (pos < 0.2125 * FS)] = 0.0
    return x, f0, pos


def jax64(fn, x, f0, positions, **kw):
    """The JAX module's `fn` in f64 on the signal rounded to f32."""
    with jax.enable_x64(True):
        out = fn(jnp.asarray(np.asarray(x, np.float32), jnp.float64),
                 jnp.asarray(f0, jnp.float64), jnp.asarray(positions), **kw)
        return np.asarray(out, np.float64)


def jax_world64(x, f0, *, fs, hop, mcep_order=59):
    """(mcep, bap) of `world_analyze`'s analysis by the JAX module in f64."""
    pos = np.arange(len(f0)) * hop
    with jax.enable_x64(True):
        sp = jax64(jw.cheaptrick, x, f0, pos, fs=fs)
        mcep = jw.sp2mc(jnp.asarray(sp), mcep_order, tw.mcepalpha(fs))
        bap = jw.code_aperiodicity(jnp.asarray(
            jax64(jw.band_aperiodicity, x, f0, pos, fs=fs)))
        return np.asarray(mcep, np.float64), np.asarray(bap, np.float64)


@pytest.fixture(scope="module")
def sig():
    x, f0, pos = signal()
    assert 0 < (f0 == 0).sum() < len(f0) // 2
    return {
        "x": x, "f0": f0, "pos": pos,
        "f32": (torch.tensor(x, dtype=torch.float32), torch.tensor(f0),
                torch.tensor(pos)),
        "f64": (torch.tensor(x, dtype=torch.float32).double(),
                torch.tensor(f0).double(), torch.tensor(pos)),
    }


def hold(got, ref, tol, what):
    """|got - ref| <= tol max |ref|; returns the error relative to that."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    assert np.isfinite(got).all(), what
    scale = np.abs(ref).max()
    err = np.abs(got - ref).max() / scale
    assert err <= tol, (what, err, tol, scale)
    return err


def hold_both(port_fn, jax_fn, sig, what, post=np.asarray, **kw):
    """`port_fn` in f64 and in f32 against `jax_fn` in f64, each output
    through `post`; returns the port's f32 output."""
    ref = post(jax64(jax_fn, sig["x"], sig["f0"], sig["pos"], **kw))
    hold(post(port_fn(*sig["f64"], **kw).numpy()), ref, TOL_F64,
         f"{what} f64")
    got = port_fn(*sig["f32"], **kw)
    assert got.dtype == torch.float32
    hold(post(got.double().numpy()), ref, TOL_F32, f"{what} f32")
    return got


def test_host_helpers_match_jax():
    for fs in (16000, 22050, 24000, 44100, 48000):
        assert tw.world_fft_size(fs) == jw.world_fft_size(fs)
        assert tw._d4c_fft_size(fs) == jw._d4c_fft_size(fs)
        assert tw.mcepalpha(fs) == jw.mcepalpha(fs)
    np.testing.assert_array_equal(tw._nuttall(1025), jw._nuttall(1025))


def test_continuous_lf0_equal_to_jax(sig):
    for f0 in (sig["f0"], np.array([0, 0, 100, 0, 0, 200, 0], np.float32),
               np.zeros(5, np.float32)):
        lf0, vuv = tw.continuous_lf0(f0)
        want_lf0, want_vuv = jw.continuous_lf0(f0)
        np.testing.assert_array_equal(lf0, want_lf0)
        np.testing.assert_array_equal(vuv, want_vuv)


def test_cheaptrick_by_the_f64_rule(sig):
    got = hold_both(tw.cheaptrick, jw.cheaptrick, sig, "log envelope",
                    post=np.log, fs=FS)
    assert got.shape == (len(sig["f0"]), 513) and (got > 0).all()


def test_sp2mc_by_the_f64_rule(sig):
    alpha = tw.mcepalpha(FS)
    ref, _ = jax_world64(sig["x"], sig["f0"], fs=FS, hop=HOP)
    for dtype, tol in (("f64", TOL_F64), ("f32", TOL_F32)):
        got = tw.sp2mc(tw.cheaptrick(*sig[dtype], fs=FS), 59, alpha)
        assert got.shape == (len(sig["f0"]), 60)
        hold(got, ref, tol, f"mcep {dtype}")
    # on the same envelope, sp2mc alone is within f32 rounding of JAX's
    sp = tw.cheaptrick(*sig["f32"], fs=FS)
    alone = jw.sp2mc(jnp.asarray(sp.numpy()), 59, alpha)
    np.testing.assert_allclose(tw.sp2mc(sp, 59, alpha).numpy(), alone,
                               rtol=0, atol=1e-5 * np.abs(alone).max())


def _freqt_f64(c, order, alpha):
    """SPTK's recursion in numpy f64, frames in parallel."""
    wc = np.zeros((c.shape[0], order + 1))
    for i in range(c.shape[1] - 1, -1, -1):
        prev, wc = wc, np.zeros_like(wc)
        wc[:, 0] = c[:, i] + alpha * prev[:, 0]
        wc[:, 1] = (1 - alpha ** 2) * prev[:, 0] + alpha * prev[:, 1]
        for m in range(2, order + 1):
            wc[:, m] = prev[:, m - 1] + alpha * (prev[:, m] - wc[:, m - 1])
    return wc


def test_freqt_matrix_against_the_jax_scan_and_an_f64_recursion():
    alpha = tw.mcepalpha(FS)
    c = np.random.default_rng(1).standard_normal((40, 513)) * np.exp(
        -np.arange(513) / 40.0)
    ref = _freqt_f64(c, 59, alpha)
    scale = np.abs(ref).max()
    got64 = tw.freqt(torch.from_numpy(c), 59, alpha).numpy()
    assert np.abs(got64 - ref).max() <= 1e-13 * scale
    got = tw.freqt(torch.from_numpy(c.astype(np.float32)), 59, alpha)
    assert got.dtype == torch.float32 and got.shape == (40, 60)
    want = np.asarray(jw.freqt(jnp.asarray(c, jnp.float32), 59, alpha))
    assert np.abs(got.numpy() - ref).max() <= 1e-6 * scale
    assert np.abs(got.numpy() - want).max() <= 1e-6 * scale
    # alpha 0 is the identity
    np.testing.assert_allclose(
        tw.freqt(torch.from_numpy(c[:3, :20]), 19, 0.0).numpy(), c[:3, :20],
        rtol=0, atol=1e-12)


def test_mc2sp_inverts_sp2mc_and_matches_jax():
    n_bins = 513
    freqs = np.linspace(0, 1, n_bins)
    sp = (1.0 + 0.5 * np.cos(2 * np.pi * 3 * freqs)) * np.exp(-2 * freqs)
    sp = np.tile(sp[None, :], (2, 1))
    mc = tw.sp2mc(torch.from_numpy(sp), 128, 0.466)
    rec = tw.mc2sp(mc, 0.466, 1024).numpy()
    assert np.abs(np.log(rec) - np.log(sp)).mean() < 0.02
    # f32 against JAX's mc2sp of the same mel-cepstrum
    mc32 = mc.float()
    got = tw.mc2sp(mc32, 0.466, 1024).numpy()
    want = np.asarray(jw.mc2sp(jnp.asarray(mc32.numpy()), 0.466, 1024))
    np.testing.assert_allclose(np.log(got), np.log(want), rtol=0, atol=1e-5)


def test_band_aperiodicity_by_the_f64_rule(sig):
    got = hold_both(tw.band_aperiodicity, jw.band_aperiodicity, sig,
                    "bap dB", post=lambda a: 20.0 * np.log10(a), fs=FS)
    assert got.shape == (len(sig["f0"]), 3)
    unvoiced = torch.from_numpy(sig["f0"] == 0)
    assert (got[unvoiced] == 0.999999).all()
    assert got[~unvoiced, 0].mean() < 0.35  # periodic below 3 kHz
    np.testing.assert_allclose(tw.code_aperiodicity(got).numpy(),
                               20.0 * np.log10(got.numpy()), rtol=1e-6)


def test_d4c_by_the_f64_rule(sig):
    got = hold_both(tw.d4c_aperiodicity, jw.d4c_aperiodicity, sig,
                    "d4c aperiodicity", fs=FS)
    assert got.shape == (len(sig["f0"]), 3)


def test_world_analyze_matches_jax(sig):
    """The pipeline's entry computes in f64 and returns f32: within f32
    rounding of JAX's analysis in f64; asked for f32, within the f32
    tolerance. Continuous log-F0 and V/UV equal to JAX's."""
    x, f0 = sig["x"], sig["f0"]
    mcep, bap, lf0, vuv = tw.world_analyze(x, f0, fs=FS, hop=HOP,
                                           device="cpu")
    m32, b32, _, _ = tw.world_analyze(x, f0, fs=FS, hop=HOP, device="cpu",
                                      dtype=torch.float32)
    want = jw.world_analyze(x, f0, fs=FS, hop=HOP)
    ref = jax_world64(x, f0, fs=FS, hop=HOP)
    for got in (mcep, bap, m32, b32):
        assert got.dtype == np.float32
    assert mcep.shape == (len(f0), 60) and bap.shape == (len(f0), 3)
    for name, got, got32, r in (("mcep", mcep, m32, ref[0]),
                                ("bap", bap, b32, ref[1])):
        hold(got, r, TOL_OUT, name)
        hold(got32, r, TOL_F32, f"{name} f32")
    np.testing.assert_array_equal(lf0, want[2])
    np.testing.assert_array_equal(vuv, want[3])


def test_world_analyze_refuses_cuda_without_a_gpu(sig, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tw.world_analyze(sig["x"], sig["f0"], fs=FS, hop=HOP)


def test_b02_world_hop_is_159_at_taco2_shiftms(monkeypatch):
    """taco2.yaml's shiftms 6.6666666666: WORLD frames 159 samples apart
    (int, as JAX), Harvest's frames round(159.99...) = 160 apart, the wave
    and loudness at hop_size 160."""
    shiftms = 6.6666666666
    assert t_pre.world_hop(24000, shiftms) == 159
    assert t_pre.world_hop(24000, shiftms) == int(24000 * shiftms / 1000)
    assert round(24000 * shiftms / 1000) == 160
    seen = {}
    real = t_pre.world_analyze

    def spy(x, f0, **kw):
        seen.update(kw, frames=len(f0), samples=len(x))
        return real(x, f0, **kw)

    monkeypatch.setattr(t_pre, "world_analyze", spy)
    x, _, _ = signal(2)
    cfg = {"sampling_rate": 24000, "hop_size": 160, "shiftms": shiftms,
           "mcep_dim": 59}
    feats = t_pre.extract_b02_features("spkA_000", x, 24000, cfg,
                                       f0min=100.0, f0max=1000.0,
                                       device="cpu")
    assert seen["hop"] == 159 and seen["fs"] == 24000
    assert seen["frames"] == len(x) // 160 + 1  # Harvest at 160
    n = len(feats["f0"])
    assert len(feats["wave"]) == min(len(x), n * 160)  # JAX's trim
    assert feats["mcep"].shape == (n, 60) and feats["bap"].shape == (n, 3)
