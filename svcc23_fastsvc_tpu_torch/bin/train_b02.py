"""B02 acoustic-model (Tacotron2) training CLI on PyTorch (the recipe's
stage 4).

Counterpart of `svcc23_fastsvc_tpu/bin/train_b02.py` on one device, with
its arguments and `--device`: builds the B02 dataset, batchers and train
task from the YAML config (conf/taco2.yaml), dumps the merged config into
the experiment dir, and runs the step loop (gen_step up to
`discriminator_train_start_steps`, gan_step after) with log/eval/save
intervals and `--resume` (the latest checkpoint of the outdir, or a given
.pkl). Checkpoints are in the reference `.pkl` layout, which the port's
`bin/decode_b02.py` decodes as they are. The config's `steps_per_call`
runs K steps a call (one captured CUDA graph on the card), and its
scalars go to a tensorboardX writer in the outdir where tensorboardX is
installed. SIGTERM checkpoints at the next step boundary and exits 75.

    python -m svcc23_fastsvc_tpu_torch.bin.train_b02 \
        --train-dumpdir dump/train --dev-dumpdir dump/dev --outdir exp \
        --config conf/taco2.yaml [--resume] [--device cuda]
"""

from __future__ import annotations

import argparse
import logging
import sys

import torch

from ..config import build_b02_task, dump_config, load_config
from ..data.collate import B02Batcher
from ..data.dataset import B02Dataset
from ..train.loop import Trainer
from .common import (
    deterministic_cudnn,
    disable_tf32,
    setup_logging,
    summary_writer,
)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Train the B02 acoustic model (PyTorch)")
    parser.add_argument("--train-dumpdir", required=True)
    parser.add_argument("--dev-dumpdir", default=None)
    parser.add_argument("--outdir", required=True)
    parser.add_argument("--config", required=True)
    parser.add_argument("--resume", default="", nargs="?", const="auto",
                        help="a checkpoint .pkl, or none for the latest "
                             "checkpoint of --outdir")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--max-frames", type=int, default=400)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)
    setup_logging(args.verbose)
    disable_tf32()
    deterministic_cudnn()  # a step repeats bit for bit; --resume is exact

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training on cuda needs a CUDA device; pass "
                           "--device cpu to run on the CPU")
    cfg = load_config(args.config)
    cfg["outdir"] = args.outdir
    dump_config(cfg, args.outdir)
    task = build_b02_task(cfg, device=device, seed=args.seed)

    def batcher(dumpdir, seed):
        return B02Batcher(B02Dataset(dumpdir),
                          batch_size=cfg.get("batch_size", 16),
                          max_frames=args.max_frames, seed=seed)

    train_batcher = batcher(args.train_dumpdir, args.seed)
    dev_batcher = (batcher(args.dev_dumpdir, args.seed + 1)
                   if args.dev_dumpdir else None)
    writer = summary_writer(args.outdir)
    trainer = Trainer(task, train_batcher, config=cfg, outdir=args.outdir,
                      dev_batcher=dev_batcher, writer=writer)
    if args.resume:
        trainer.resume(None if args.resume == "auto" else args.resume)
    trainer.install_preemption_handler()
    try:
        trainer.run()
    finally:
        if writer is not None:
            writer.close()
    if trainer.preempted:
        # EX_TEMPFAIL: a graceful preemption with a resumable checkpoint
        logging.info("preempted; checkpoint saved - exiting 75")
        sys.exit(75)
    logging.info("finished B02 training.")


if __name__ == "__main__":
    main()
