"""B02 stage 3: apply the fitted scalers to a dump.

Counterpart of `svcc23_fastsvc_tpu/bin/normalize_b02.py` (reference
normalize_b02.py:119-164): each utterance's file is written into the
output directory under its own name, wave / f0 / vuv as they are and
ppg / mcep / bap / lf0 / lft / spk_emb scaler-transformed to f32, on the
host. `normalize_b02_features` is the in-memory half, over a feature
dict.

    python -m svcc23_fastsvc_tpu_torch.bin.normalize_b02 \
        --dumpdir dump/train --outdir dump/train_norm \
        --stats dump/stats_b02.joblib
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from ..data.dataset import find_files
from ..data.hdf5 import read_hdf5, write_hdf5
from ..utils.scalers import load_scaler
from .common import setup_logging
from .compute_statistics_b02 import scaler_rows

KEPT = ("wave", "f0", "vuv")
SCALED = ("ppg", "mcep", "bap", "lf0", "lft", "spk_emb")


def normalize_b02_features(feats: dict, scalers: dict) -> dict:
    """The normalised bundle of one utterance: KEPT as they are, SCALED
    transformed (`scaler_rows`' shapes), in f32."""
    out = {k: feats[k] for k in KEPT}
    for k in SCALED:
        out[k] = np.asarray(scalers[k].transform(scaler_rows(k, feats[k])),
                            np.float32)
    return out


def normalize_b02(dumpdir: str, outdir: str, stats_path: str):
    scalers = load_scaler(stats_path)
    os.makedirs(outdir, exist_ok=True)
    files = find_files(dumpdir)
    for f in files:
        out = os.path.join(outdir, os.path.basename(f))
        feats = {k: read_hdf5(f, k) for k in KEPT + SCALED}
        for k, v in normalize_b02_features(feats, scalers).items():
            write_hdf5(out, k, v)
    logging.info("normalized %d utterances -> %s", len(files), outdir)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Normalize a B02 dump")
    parser.add_argument("--dumpdir", required=True)
    parser.add_argument("--outdir", required=True)
    parser.add_argument("--stats", required=True)
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)
    setup_logging(args.verbose)
    normalize_b02(args.dumpdir, args.outdir, args.stats)


if __name__ == "__main__":
    main()
