"""The port's front-end signal processing against the JAX package on the
CPU: the STFT's keywords, loudness, the mel filterbank, YIN, trimming,
Harvest, the scalers and stats files.

Inputs are made with numpy from a seed and go through both packages. The
training losses' STFT is also held, bit for bit, to a frozen copy of the
port's implementation before the keywords were added.
"""

import importlib
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from svcc23_fastsvc_tpu.dsp.f0 import F0Statistics as JaxF0Stats
from svcc23_fastsvc_tpu.dsp.f0 import yin_f0 as jax_yin
from svcc23_fastsvc_tpu.dsp.harvest import harvest_f0 as jax_harvest
from svcc23_fastsvc_tpu.dsp.trim import trim_silence as jax_trim
from svcc23_fastsvc_tpu.utils import scalers as jscalers
from svcc23_fastsvc_tpu_torch.dsp.f0 import F0Statistics, yin_f0
from svcc23_fastsvc_tpu_torch.dsp.harvest import harvest_f0
from svcc23_fastsvc_tpu_torch.dsp.trim import trim_silence
from svcc23_fastsvc_tpu_torch.utils import scalers as tscalers

# the packages' `ops` export a function `stft` that hides the module
jstft = importlib.import_module("svcc23_fastsvc_tpu.ops.stft")
tstft = importlib.import_module("svcc23_fastsvc_tpu_torch.ops.stft")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000


def _rng(seed=0):
    return np.random.default_rng(seed)


def vibrato(f0=220.0, dur=1.0, sr=SR, seed=0):
    t = np.arange(int(dur * sr)) / sr
    inst = f0 * (1 + 0.03 * np.sin(2 * np.pi * 5.5 * t))
    phase = 2 * np.pi * np.cumsum(inst) / sr
    x = sum(0.5 ** k * np.sin((k + 1) * phase) for k in range(3))
    return 0.3 * x + 0.001 * _rng(seed).standard_normal(len(t))


def chirp(f_lo=90.0, f_hi=320.0, dur=1.0, sr=SR):
    t = np.arange(int(dur * sr)) / sr
    inst = f_lo * (f_hi / f_lo) ** (t / dur)
    return 0.4 * np.sin(2 * np.pi * np.cumsum(inst) / sr)


SIGNALS = {
    "vibrato": vibrato(),
    "chirp": chirp(),
    "noise": 0.1 * _rng(3).standard_normal(SR),
    "silence": np.zeros(SR),
}


# the port's stft_magnitude before the front end's keywords, frozen: the
# training losses' path must keep these bits
def _loss_stft_magnitude_before(x, fft_size, hop, win_length=None):
    win_length = win_length or fft_size
    n = torch.arange(win_length, dtype=torch.float64, device=x.device)
    window = (0.5 - 0.5 * torch.cos(2.0 * math.pi * n / win_length)).to(
        x.dtype)
    lpad = (fft_size - win_length) // 2
    window = F.pad(window, (lpad, fft_size - win_length - lpad))
    pad = fft_size // 2
    lead = x.shape[:-1]
    x = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect")
    x = x.reshape(*lead, x.shape[-1])
    z = torch.fft.rfft(x.unfold(-1, fft_size, hop) * window, dim=-1)
    return torch.sqrt(torch.clamp(z.real ** 2 + z.imag ** 2, min=1e-7))


@pytest.mark.parametrize("fft,hop,win", [(2048, 512, 2048), (512, 128, 240),
                                         (64, 16, 64)])
def test_loss_path_stft_magnitude_keeps_its_bits(fft, hop, win):
    x = torch.from_numpy(_rng(1).standard_normal((3, 4000)).astype(np.float32))
    want = _loss_stft_magnitude_before(x, fft, hop, win)
    assert torch.equal(tstft.stft_magnitude(x, fft, hop, win), want)


# each keyword of stft_magnitude, against the JAX function; f32 FFTs of
# two libraries: within 1e-5 of the largest value
STFT_KWARGS = {
    "window": dict(window="ones"),
    "center_off": dict(center=False),
    "constant_pad": dict(pad_mode="constant"),
    "power": dict(power=True),
    "clamp_0": dict(power=True, clamp_min=0.0),
    "all": dict(window="ones", pad_mode="constant", power=True,
                clamp_min=0.0),
}


@pytest.mark.parametrize("name", sorted(STFT_KWARGS))
def test_stft_magnitude_keywords_match_jax(name):
    kw = dict(STFT_KWARGS[name])
    fft, hop, win = 1024, 160, 800
    x = _rng(2).standard_normal((2, 6000)).astype(np.float32)
    tkw, jkw = dict(kw), dict(kw)
    if kw.get("window") == "ones":
        tkw["window"] = torch.ones(win)
        jkw["window"] = jnp.ones(win)
    want = np.asarray(jstft.stft_magnitude(jnp.asarray(x), fft, hop, win,
                                           **jkw))
    got = tstft.stft_magnitude(torch.from_numpy(x), fft, hop, win,
                               **tkw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("sr,hop", [(16000, 64), (24000, 64)])
def test_loudness_extract_matches_jax(sr, hop):
    x = (vibrato(sr=sr, dur=0.8) * np.linspace(0.1, 1.0, int(0.8 * sr)))
    x = x.astype(np.float32)
    want = np.asarray(jstft.loudness_extract(jnp.asarray(x), sr, hop))
    got = tstft.loudness_extract(torch.from_numpy(x), sr, hop).numpy()
    assert got.shape == want.shape == ((len(x) // hop + 1) * hop,)
    # log-loudness of f32 spectra: within 1e-4 (absolute, in nepers)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("args", [(16000, 1024, 80, {}),
                                  (16000, 400, 24, {}),
                                  (24000, 2048, 40, dict(fmin=50.0,
                                                         fmax=8000.0)),
                                  (16000, 512, 20, dict(htk=True,
                                                        norm=None))])
def test_mel_filterbank_equals_jax(args):
    sr, n_fft, n_mels, kw = args
    want = np.asarray(jstft.mel_filterbank(sr, n_fft, n_mels, **kw))
    got = tstft.mel_filterbank(sr, n_fft, n_mels, **kw).numpy()
    np.testing.assert_array_equal(got, want)  # both numpy f64, then f32
    np.testing.assert_array_equal(
        tstft.a_weighting_db(tstft.fft_frequencies(sr, n_fft)),
        jstft.a_weighting_db(jstft.fft_frequencies(sr, n_fft)))


@pytest.mark.parametrize("name", sorted(SIGNALS))
def test_yin_matches_jax(name):
    x = SIGNALS[name].astype(np.float32)
    want = np.asarray(jax_yin(jnp.asarray(x), sr=SR, hop=160))
    got = yin_f0(torch.from_numpy(x), sr=SR, hop=160).numpy()
    assert got.shape == want.shape == (len(x) // 160 + 1,)
    np.testing.assert_array_equal(got > 0, want > 0)  # identical voicing
    v = want > 0
    if name in ("vibrato", "chirp"):
        assert v.mean() > 0.8
    np.testing.assert_allclose(got[v], want[v], rtol=1e-4)


@pytest.mark.parametrize("kw", [dict(), dict(top_db=30.0),
                                dict(frame_length=1024, hop_length=256)])
def test_trim_silence_equals_jax(kw):
    x = np.concatenate([np.zeros(4000), vibrato(dur=0.5),
                        1e-5 * _rng(4).standard_normal(3000)])
    got, span = trim_silence(x, **kw)
    want, want_span = jax_trim(x, **kw)
    assert span == want_span and 0 < span[0] < span[1] < len(x)
    np.testing.assert_array_equal(got, want)


def test_harvest_bit_equal_to_jax():
    for x in (vibrato(dur=0.7), chirp(dur=0.5), SIGNALS["silence"][:3000]):
        got = harvest_f0(x, fs=SR, f0_floor=70.0, f0_ceil=400.0)
        want = jax_harvest(x, fs=SR, f0_floor=70.0, f0_ceil=400.0)
        assert got.dtype == np.float64 and got.shape == (len(x) // 160 + 1,)
        np.testing.assert_array_equal(got, want)


def test_harvest_raises_without_a_library(monkeypatch):
    from svcc23_fastsvc_tpu_torch.dsp import harvest

    monkeypatch.setattr(harvest, "_lib", None)
    monkeypatch.setattr(harvest, "SOURCE", os.path.join(REPO, "no.cpp"))
    with pytest.raises(RuntimeError, match="source missing"):
        harvest_f0(np.zeros(1600), fs=SR)


def test_f0_statistics_equal_jax():
    f0s = [np.where(_rng(i).random(200) > 0.3,
                    _rng(i + 9).uniform(90, 300, 200), 0.0) for i in range(3)]
    np.testing.assert_array_equal(F0Statistics().estimate(f0s),
                                  JaxF0Stats().estimate(f0s))


@pytest.mark.parametrize("kind", ["StandardScaler", "MinMaxScaler"])
def test_scalers_equal_jax(kind):
    X = _rng(5).standard_normal((300, 6)) * [1, 2, 3, 4, 5, 6] + 2
    port, ref = getattr(tscalers, kind)(), getattr(jscalers, kind)()
    for chunk in np.array_split(X, [40, 170]):
        port.partial_fit(chunk.astype(np.float32))
        ref.partial_fit(chunk.astype(np.float32))
    for attr in ("scale_", "mean_", "var_", "data_min_", "data_max_", "min_"):
        if hasattr(ref, attr):
            np.testing.assert_array_equal(getattr(port, attr),
                                          getattr(ref, attr))
    np.testing.assert_array_equal(port.transform(X), ref.transform(X))
    np.testing.assert_array_equal(port.inverse_transform(X),
                                  ref.inverse_transform(X))


def test_stats_files_cross_between_packages(tmp_path):
    X = _rng(6).standard_normal((120, 4))
    jax_scaler = jscalers.StandardScaler().partial_fit(X)
    jscalers.save_scaler(jax_scaler, str(tmp_path / "jax.joblib"))
    port_scaler = tscalers.StandardScaler().partial_fit(X)
    tscalers.save_scaler(port_scaler, str(tmp_path / "port.joblib"))
    # the JAX CLIs read the port's file
    np.testing.assert_array_equal(
        jscalers.load_scaler(str(tmp_path / "port.joblib")).transform(X),
        jax_scaler.transform(X))
    # a global that is not a scaler is refused
    import joblib

    joblib.dump({"f": os.system}, str(tmp_path / "bad.joblib"))
    with pytest.raises(Exception, match="not a scaler"):
        tscalers.load_scaler(str(tmp_path / "bad.joblib"))


LOAD_PROBE = r"""
import sys
import numpy as np
from svcc23_fastsvc_tpu_torch.utils.scalers import StandardScaler, load_scaler
s = load_scaler(sys.argv[1])
assert type(s) is StandardScaler, type(s)
np.save(sys.argv[2], s.transform(np.load(sys.argv[3])))
bad = sorted(m for m in sys.modules
             if m == "svcc23_fastsvc_tpu" or m.startswith(
                 ("svcc23_fastsvc_tpu.", "jax", "sklearn")))
print(bad)
"""


def test_jax_written_stats_load_without_the_jax_package(tmp_path):
    X = _rng(7).standard_normal((80, 5)) * 3 + 1
    ref = jscalers.StandardScaler()
    ref.partial_fit(X[:30])
    ref.partial_fit(X[30:])
    jscalers.save_scaler(ref, str(tmp_path / "stats.joblib"))
    np.save(tmp_path / "x.npy", X)
    out = subprocess.run(
        [sys.executable, "-c", LOAD_PROBE, str(tmp_path / "stats.joblib"),
         str(tmp_path / "y.npy"), str(tmp_path / "x.npy")],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
    np.testing.assert_array_equal(np.load(tmp_path / "y.npy"),
                                  ref.transform(X))
