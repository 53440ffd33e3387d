"""Stage 2: per-speaker log-F0 statistics of a dump.

Counterpart of `svcc23_fastsvc_tpu/bin/compute_f0stats.py`: the voiced F0
frames of each speaker's utterances give `<outdir>/<spk>.yml` with the
log-F0 mean and std (decode shifts by the mean), on the host.

    python -m svcc23_fastsvc_tpu_torch.bin.compute_f0stats \
        --dumpdir dump/train/raw --outdir dump/f0_stats
"""

from __future__ import annotations

import argparse
import logging
import os
from collections import defaultdict

import numpy as np

from ..data.dataset import find_files
from ..data.hdf5 import read_hdf5
from ..dsp.f0 import F0Statistics
from .common import setup_logging, utt_speaker


def compute_f0stats(dumpdir: str, outdir: str) -> dict:
    import yaml

    files = find_files(dumpdir)
    if not files:
        raise FileNotFoundError(f"no .h5 files under {dumpdir}")
    per_spk = defaultdict(list)
    for f in files:
        utt_id = os.path.splitext(os.path.basename(f))[0]
        per_spk[utt_speaker(utt_id)].append(np.asarray(read_hdf5(f, "f0")))
    os.makedirs(outdir, exist_ok=True)
    stats = F0Statistics()
    out = {}
    for spk, f0list in per_spk.items():
        mean, std = stats.estimate(f0list)
        out[spk] = {"f0_mean": float(mean), "f0_std": float(std)}
        with open(os.path.join(outdir, f"{spk}.yml"), "w") as f:
            yaml.safe_dump(out[spk], f)
    logging.info("wrote f0 stats for %d speakers -> %s", len(out), outdir)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description="Per-speaker F0 statistics")
    parser.add_argument("--dumpdir", required=True)
    parser.add_argument("--outdir", required=True)
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)
    setup_logging(args.verbose)
    compute_f0stats(args.dumpdir, args.outdir)


if __name__ == "__main__":
    main()
