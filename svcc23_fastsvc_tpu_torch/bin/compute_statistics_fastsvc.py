"""Stage 3a: fit the PPG StandardScaler over a training dump.

Counterpart of `svcc23_fastsvc_tpu/bin/compute_statistics_fastsvc.py`:
only the PPG is scaled (F0 is not: results degrade if it is), the
utterances in `find_files` order, and the scaler is written as
`stats.joblib` (`utils/scalers.py`), on the host.

    python -m svcc23_fastsvc_tpu_torch.bin.compute_statistics_fastsvc \
        --dumpdir dump/train/raw --dumpfile dump/train/stats.joblib
"""

from __future__ import annotations

import argparse
import logging

from ..data.dataset import find_files
from ..data.hdf5 import read_hdf5
from ..utils.scalers import StandardScaler, save_scaler
from .common import setup_logging


def compute_statistics(dumpdir: str, out_path: str) -> StandardScaler:
    files = find_files(dumpdir)
    if not files:
        raise FileNotFoundError(f"no .h5 files under {dumpdir}")
    scaler = StandardScaler()
    for f in files:
        scaler.partial_fit(read_hdf5(f, "ppg"))
    save_scaler(scaler, out_path)
    logging.info("fitted scaler over %d utterances -> %s", len(files),
                 out_path)
    return scaler


def main(argv=None):
    parser = argparse.ArgumentParser(description="Fit the PPG scaler")
    parser.add_argument("--dumpdir", required=True)
    parser.add_argument("--dumpfile", required=True, help="output stats.joblib")
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)
    setup_logging(args.verbose)
    compute_statistics(args.dumpdir, args.dumpfile)


if __name__ == "__main__":
    main()
