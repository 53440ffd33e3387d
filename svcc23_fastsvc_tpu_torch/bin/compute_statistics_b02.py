"""B02 stage 2: fit the feature scalers over a training dump.

Counterpart of `svcc23_fastsvc_tpu/bin/compute_statistics_b02.py`
(reference compute_statistics_b02.py:89-104): a MinMaxScaler each for
ppg, lf0, lft and spk_emb, a StandardScaler each for mcep and bap, fitted
utterance by utterance in `find_files` order and written as one joblib
dict (`utils/scalers.py`), on the host. `fit_b02_scalers` is the
in-memory half, over feature dicts.

    python -m svcc23_fastsvc_tpu_torch.bin.compute_statistics_b02 \
        --dumpdir dump/train --dumpfile dump/stats_b02.joblib
"""

from __future__ import annotations

import argparse
import logging

import numpy as np

from ..data.dataset import B02Dataset
from ..utils.scalers import MinMaxScaler, StandardScaler, save_scaler
from .common import setup_logging

MINMAX = ("ppg", "lf0", "lft", "spk_emb")
STANDARD = ("mcep", "bap")


def scaler_rows(name: str, x) -> np.ndarray:
    """A feature as its scaler sees it: lf0 and lft as column vectors,
    spk_emb as one row, the rest as stored."""
    x = np.asarray(x)
    if name == "spk_emb":
        return x.reshape(1, -1)
    return x.reshape(-1, 1) if name in ("lf0", "lft") else x


def fit_b02_scalers(utterances) -> dict:
    """Scalers fitted over an iterable of feature dicts (ppg, lf0, lft,
    spk_emb, mcep, bap)."""
    scalers = {**{k: MinMaxScaler() for k in MINMAX},
               **{k: StandardScaler() for k in STANDARD}}
    for feats in utterances:
        for k, scaler in scalers.items():
            scaler.partial_fit(scaler_rows(k, feats[k]))
    return scalers


def compute_statistics_b02(dumpdir: str, out_path: str) -> dict:
    ds = B02Dataset(dumpdir, allow_cache=False)
    scalers = fit_b02_scalers(
        dict(zip(B02Dataset.FIELDS, ds[i][1:])) for i in range(len(ds)))
    save_scaler(scalers, out_path)
    logging.info("fitted B02 scalers over %d utterances -> %s", len(ds),
                 out_path)
    return scalers


def main(argv=None):
    parser = argparse.ArgumentParser(description="Fit the B02 scalers")
    parser.add_argument("--dumpdir", required=True)
    parser.add_argument("--dumpfile", required=True,
                        help="output stats joblib")
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)
    setup_logging(args.verbose)
    compute_statistics_b02(args.dumpdir, args.dumpfile)


if __name__ == "__main__":
    main()
