"""F0 helpers: the log-F0 conversion between speakers (decode's F0 mean
shift) and the vocoder's pitch-dependent dilation factors."""

from __future__ import annotations

import numpy as np


class F0Statistics:
    """Counterpart of `svcc23_fastsvc_tpu/dsp/f0.py::F0Statistics.convert`:
    exp((std_t / std_s)(log f0 - mean_s) + mean_t) on voiced frames."""

    def convert(self, f0, orgf0stats, tarf0stats):
        f0 = np.asarray(f0, dtype=np.float64)
        cvf0 = np.zeros_like(f0)
        nz = f0 > 0
        cvf0[nz] = np.exp(
            (tarf0stats[1] / orgf0stats[1]) * (np.log(f0[nz]) - orgf0stats[0])
            + tarf0stats[0]
        )
        return cvf0


def dilated_factor(batch_f0, fs: int, dense_factor: int):
    """Pitch-dependent dilation factors fs / (f0 * dense_factor), in f64,
    unvoiced frames taking 1 (`svcc23_fastsvc_tpu/dsp/f0.py::
    dilated_factor`)."""
    f0 = np.asarray(batch_f0, dtype=np.float64).copy()
    f0[f0 == 0] = fs / dense_factor
    factors = np.ones(f0.shape) * fs / f0 / dense_factor
    factors[factors <= 0] = 1
    return factors
