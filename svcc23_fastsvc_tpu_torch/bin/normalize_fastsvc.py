"""Stage 3b: apply the fitted scaler to the PPGs of a dump.

Counterpart of `svcc23_fastsvc_tpu/bin/normalize_fastsvc.py`: each
utterance's file is written into the output directory under its own name,
wave / f0 / lft / spk_emb as they are and the PPG scaler-transformed, on
the host.

    python -m svcc23_fastsvc_tpu_torch.bin.normalize_fastsvc \
        --dumpdir dump/train/raw --outdir dump/train/norm \
        --stats dump/train/stats.joblib
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


def normalize(dumpdir: str, outdir: str, stats_path: str):
    scaler = load_scaler(stats_path)
    os.makedirs(outdir, exist_ok=True)
    files = find_files(dumpdir)
    for f in files:
        out = os.path.join(outdir, os.path.basename(f))
        for name in ("wave", "f0", "lft", "spk_emb"):
            write_hdf5(out, name, read_hdf5(f, name))
        ppg = scaler.transform(read_hdf5(f, "ppg"))
        write_hdf5(out, "ppg", np.asarray(ppg, np.float32))
    logging.info("normalized %d utterances -> %s", len(files), outdir)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Normalize the PPGs")
    parser.add_argument("--dumpdir", required=True)
    parser.add_argument("--outdir", required=True)
    parser.add_argument("--stats", required=True)
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)
    setup_logging(args.verbose)
    normalize(args.dumpdir, args.outdir, args.stats)


if __name__ == "__main__":
    main()
