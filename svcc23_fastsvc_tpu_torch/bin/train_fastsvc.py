"""FastSVC GAN training CLI on PyTorch (the recipe's stage 4).

Counterpart of `svcc23_fastsvc_tpu/bin/train_fastsvc.py` on one device:
builds the dataset, batchers and train task from the YAML config, dumps the
merged config into the experiment dir (decode reads it back), and runs the
step loop with log/eval/save intervals, `--resume` (the latest checkpoint
of the outdir, or a given .pkl) and `--pretrain` (weights only). The
config's `loader_threads` > 1 feeds the steps from the native batch
producer (`data/native_batch.py`: C++ threads crop and assemble, a
`BatcherPool` of that many Python threads where the crops take context
frames), as the JAX CLI does; `loader_threads` 1 runs the batcher behind
the trainer's prefetch thread. Scalars go to a tensorboardX writer in the
outdir where tensorboardX is installed. SIGTERM checkpoints at the next
step boundary and exits 75.

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
from ..data.native_batch import make_native_producer
from ..data.prefetch import BatcherPool
from ..train.loop import Trainer
from .common import (
    deterministic_cudnn,
    disable_tf32,
    setup_logging,
    summary_writer,
)


def make_train_batcher(cfg: dict, make_batcher, seed: int):
    """The training batches the config's `loader_threads` asks for, as the
    JAX CLI builds them: above 1, the native producer of that many C++
    threads (`hold` 2K slots for K-step calls), or a `BatcherPool` of that
    many Python threads where the crops take context frames; else the
    batcher itself. `make_batcher(seed)` makes a `FastSVCBatcher`."""
    n = int(cfg.get("loader_threads", 1))
    if n <= 1:
        return make_batcher(seed)
    producer = make_native_producer(
        make_batcher(seed), n_threads=n, seed=seed,
        hold=2 * max(1, int(cfg.get("steps_per_call", 1))))
    if producer is not None:
        logging.info("native batch producer (%d threads)", n)
        return producer
    logging.info("aux_context_window crops: Python batcher pool (%d "
                 "threads)", n)
    return BatcherPool(make_batcher, n_threads=n, seed=seed)


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
    disable_tf32()
    deterministic_cudnn()  # a step repeats bit for bit; --resume is exact

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training on cuda needs a CUDA device; pass "
                           "--device cpu to run on the CPU")
    cfg = load_config(args.config)
    cfg["outdir"] = args.outdir
    dump_config(cfg, args.outdir)
    task = build_train_task(cfg, device=device, seed=args.seed)

    use_spk_emb = cfg.get("generator_params", {}).get("use_spk_emb", True)

    def batcher(dataset, seed, acw):
        return FastSVCBatcher(
            dataset, batch_size=cfg["batch_size"],
            batch_length=cfg["batch_length"], hop_size=cfg["hop_size"],
            aux_context_window=acw, use_spk_emb=use_spk_emb, seed=seed)

    train_ds = FastSVCDataset(args.train_dumpdir)
    train_batcher = make_train_batcher(
        cfg, lambda seed: batcher(train_ds, seed,
                                  cfg.get("aux_context_window", 0)),
        args.seed)
    dev_batcher = (batcher(FastSVCDataset(args.dev_dumpdir), args.seed + 1,
                           0) if args.dev_dumpdir else None)

    writer = summary_writer(args.outdir)
    trainer = Trainer(task, train_batcher, config=cfg, outdir=args.outdir,
                      dev_batcher=dev_batcher, writer=writer)
    if args.pretrain:
        trainer.resume(args.pretrain, params_only=True)
    if args.resume:
        trainer.resume(None if args.resume == "auto" else args.resume)
    trainer.install_preemption_handler()
    try:
        trainer.run()
    finally:
        for closable in (train_batcher, writer):
            if hasattr(closable, "close"):
                closable.close()
    if trainer.preempted:
        # EX_TEMPFAIL: a graceful preemption with a resumable checkpoint
        logging.info("preempted; checkpoint saved - exiting 75")
        sys.exit(75)
    logging.info("finished training.")


if __name__ == "__main__":
    main()
