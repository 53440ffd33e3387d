"""Split a wav.scp into train and dev, every speaker in dev.

Counterpart of `svcc23_fastsvc_tpu/bin/split_train_dev.py` (reference
egs/svcc23/fastsvc1/utils/split_train_dev.py), pure Python: utterance ids
are `{speaker}_{rest}`; the first `--dev-count` utterances of each
speaker go to the dev scp, the rest to train, in the source's order;
lines without an id and a path are skipped and counted.

    python -m svcc23_fastsvc_tpu_torch.bin.split_train_dev \
        --source-scp data/all/wav.scp --train-scp-out data/train/wav.scp \
        --dev-scp-out data/dev/wav.scp [--dev-count 2]
"""

from __future__ import annotations

import argparse
import collections

from .common import utt_speaker


def split_wav_scp(src: str, train_out: str, dev_out: str, dev_count: int):
    """(dev utterances per speaker, invalid lines skipped)."""
    counts: dict = collections.Counter()
    n_bad = 0
    with open(src) as f, open(train_out, "w") as tr, open(dev_out, "w") as dv:
        for line in f:
            parts = line.strip().split(None, 1)
            if len(parts) != 2:
                if line.strip():
                    n_bad += 1
                continue
            utt_id, path = parts
            spk = utt_speaker(utt_id)
            dst = dv if counts[spk] < dev_count else tr
            counts[spk] += 1 if dst is dv else 0
            dst.write(f"{utt_id} {path}\n")
    return dict(counts), n_bad


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--source-scp", required=True)
    p.add_argument("--train-scp-out", required=True)
    p.add_argument("--dev-scp-out", required=True)
    p.add_argument("--dev-count", type=int, default=2,
                   help="dev utterances per speaker")
    args = p.parse_args(argv)
    counts, n_bad = split_wav_scp(
        args.source_scp, args.train_scp_out, args.dev_scp_out, args.dev_count
    )
    print(f"split {sum(counts.values())} dev utts over {len(counts)} speakers"
          + (f" ({n_bad} invalid lines skipped)" if n_bad else ""))


if __name__ == "__main__":
    main()
