"""FastSVC GAN training CLI on PyTorch (the recipe's stage 4).

Counterpart of `svcc23_fastsvc_tpu/bin/train_fastsvc.py` on one device:
builds the dataset, batchers and train task from the YAML config, dumps the
merged config into the experiment dir (decode reads it back), and runs the
step loop with log/eval/save intervals, `--resume` (the latest checkpoint
of the outdir, or a given .pkl) and `--pretrain` (weights only). SIGTERM
checkpoints at the next step boundary and exits 75.

    python -m svcc23_fastsvc_tpu_torch.bin.train_fastsvc \
        --train-dumpdir dump/train --dev-dumpdir dump/dev --outdir exp \
        --config conf/fastsvc.yaml [--resume] [--device cuda]
"""

from __future__ import annotations

import argparse
import logging
import sys

import torch

from ..config import build_train_task, dump_config, load_config
from ..data.collate import FastSVCBatcher
from ..data.dataset import FastSVCDataset
from ..train.loop import Trainer
from .common import setup_logging


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train FastSVC (PyTorch)")
    parser.add_argument("--train-dumpdir", required=True)
    parser.add_argument("--dev-dumpdir", default=None)
    parser.add_argument("--outdir", required=True)
    parser.add_argument("--config", required=True)
    parser.add_argument("--resume", default="", nargs="?", const="auto",
                        help="a checkpoint .pkl, or none for the latest "
                             "checkpoint of --outdir")
    parser.add_argument("--pretrain", default="",
                        help="a checkpoint .pkl to take the weights from")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)
    setup_logging(args.verbose)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training on cuda needs a CUDA device; pass "
                           "--device cpu to run on the CPU")
    cfg = load_config(args.config)
    cfg["outdir"] = args.outdir
    dump_config(cfg, args.outdir)
    task = build_train_task(cfg, device=device, seed=args.seed)

    use_spk_emb = cfg.get("generator_params", {}).get("use_spk_emb", True)

    def batcher(dumpdir, seed, acw):
        return FastSVCBatcher(
            FastSVCDataset(dumpdir), batch_size=cfg["batch_size"],
            batch_length=cfg["batch_length"], hop_size=cfg["hop_size"],
            aux_context_window=acw, use_spk_emb=use_spk_emb, seed=seed)

    train_batcher = batcher(args.train_dumpdir, args.seed,
                            cfg.get("aux_context_window", 0))
    dev_batcher = (batcher(args.dev_dumpdir, args.seed + 1, 0)
                   if args.dev_dumpdir else None)

    trainer = Trainer(task, train_batcher, config=cfg, outdir=args.outdir,
                      dev_batcher=dev_batcher)
    if args.pretrain:
        trainer.resume(args.pretrain, params_only=True)
    if args.resume:
        trainer.resume(None if args.resume == "auto" else args.resume)
    trainer.install_preemption_handler()
    trainer.run()
    if trainer.preempted:
        # EX_TEMPFAIL: a graceful preemption with a resumable checkpoint
        logging.info("preempted; checkpoint saved - exiting 75")
        sys.exit(75)
    logging.info("finished training.")


if __name__ == "__main__":
    main()
