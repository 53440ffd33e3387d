"""FastSVC GAN training CLI on PyTorch (the recipe's stage 4).

Counterpart of `svcc23_fastsvc_tpu/bin/train_fastsvc.py`, on one device or
as one of `--n-procs` data-parallel processes:
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

Data parallelism, one process a device (`parallel/`): `--n-procs N
--proc-id I --coordinator H:P` makes this process rank I of N, joined
over TCP at the coordinator (NCCL on the card, each rank on `cuda:{I %
cards}`; gloo on the CPU; `SVC_DIST_BACKEND` names one). The config's
`batch_size` is the global batch: each rank loads batch_size / N rows
from its own seeded stream (seed + 1000 I), the dev stream is seed + 1 on
every rank, rank 0 writes config.yml, the checkpoints and the
tensorboard scalars, and every rank logs its parameters' checksum at the
end. `--n-devices N` > 1 starts the N ranks on this host itself (through
`utils/launcher.py`'s local backend); its default, every CUDA device (1
on the CPU), keeps one process on a one-card machine.

    python -m svcc23_fastsvc_tpu_torch.bin.train_fastsvc \
        --train-dumpdir dump/train --dev-dumpdir dump/dev --outdir exp \
        --config conf/fastsvc.yaml [--resume] [--device cuda] \
        [--n-procs N --proc-id I --coordinator host:port]
"""

from __future__ import annotations

import argparse
import logging
import os
import socket
import sys

import torch
import torch.distributed as dist

from ..config import build_train_task, dump_config, load_config
from ..data.collate import FastSVCBatcher
from ..data.dataset import FastSVCDataset
from ..data.native_batch import make_native_producer
from ..data.prefetch import BatcherPool
from ..parallel import initialize, make_mesh
from ..parallel.distributed import replica_checksum
from ..train.loop import Trainer
from ..utils import launcher
from .common import (
    deterministic_cudnn,
    disable_tf32,
    log_kernel_launches,
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


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_local_ranks(argv: list, n: int, outdir: str):
    """This command as N ranks on this host (`--n-procs N --proc-id {job}`
    over a free local port), through the launcher's local backend; logs
    under <outdir>/log/train.<rank>.log. Raises if a rank fails."""
    kept, i = [], 0
    while i < len(argv):  # the ranks get --n-procs instead of --n-devices
        if argv[i] == "--n-devices":
            i += 2
            continue
        if not argv[i].startswith("--n-devices="):
            kept.append(argv[i])
        i += 1
    cmd = [sys.executable, "-m", "svcc23_fastsvc_tpu_torch.bin.train_fastsvc",
           *kept, "--n-procs", str(n), "--proc-id", "{job}",
           "--coordinator", f"127.0.0.1:{_free_port()}"]
    logging.info("starting %d local ranks", n)
    launcher.launch(cmd, n, backend="local", max_parallel=n,
                    log_dir=os.path.join(outdir, "log"), name="train")


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
    parser.add_argument("--n-devices", type=int, default=None,
                        help="data-parallel devices (default: all)")
    parser.add_argument("--n-procs", type=int, default=None,
                        help="multi-host: total number of launcher processes")
    parser.add_argument("--proc-id", type=int, default=None,
                        help="multi-host: this process's index (0-based)")
    parser.add_argument("--coordinator", default=None,
                        help="multi-host: coordinator address host:port")
    parser.add_argument("--verbose", type=int, default=1)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser.parse_args(argv)
    setup_logging(args.verbose)
    disable_tf32()
    deterministic_cudnn()  # a step repeats bit for bit; --resume is exact

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training on cuda needs a CUDA device; pass "
                           "--device cpu to run on the CPU")
    # the processes join before any device use; afterwards the world is
    # every rank and this process drives its own device
    multihost = bool(args.n_procs and args.n_procs > 1)
    if not multihost:
        n_local = args.n_devices if args.n_devices is not None else (
            torch.cuda.device_count() if device.type == "cuda" else 1)
        if n_local > 1:
            launch_local_ranks(argv, n_local, args.outdir)
            return
    try:
        if multihost:
            device = initialize(args.coordinator, args.n_procs, args.proc_id,
                                device=device)
        _train(args, device, multihost)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _train(args, device, multihost: bool):
    rank = dist.get_rank() if multihost else 0
    world = dist.get_world_size() if multihost else 1
    cfg = load_config(args.config)
    cfg["outdir"] = args.outdir
    if rank == 0:
        dump_config(cfg, args.outdir)
    task = build_train_task(cfg, device=device, seed=args.seed)

    # each process loads its share of the global batch: the config's
    # batch_size is what the optimizer sees a step, across the processes
    local_bs, rem = divmod(cfg["batch_size"], world)
    if rem:
        raise ValueError(f"batch_size {cfg['batch_size']} not divisible by "
                         f"{world} processes")
    use_spk_emb = cfg.get("generator_params", {}).get("use_spk_emb", True)

    def batcher(dataset, seed, acw):
        return FastSVCBatcher(
            dataset, batch_size=local_bs,
            batch_length=cfg["batch_length"], hop_size=cfg["hop_size"],
            aux_context_window=acw, use_spk_emb=use_spk_emb, seed=seed)

    train_ds = FastSVCDataset(args.train_dumpdir)
    # disjoint per-process streams (the HostShardedBatcher convention)
    train_batcher = make_train_batcher(
        cfg, lambda seed: batcher(train_ds, seed,
                                  cfg.get("aux_context_window", 0)),
        args.seed + 1000 * rank)
    # the same dev stream on every process
    dev_batcher = (batcher(FastSVCDataset(args.dev_dumpdir), args.seed + 1,
                           0) if args.dev_dumpdir else None)

    mesh = None
    if multihost:
        mesh = make_mesh()
        logging.info("data-parallel over %d devices (%d processes)", world,
                     world)
    writer = summary_writer(args.outdir) if rank == 0 else None
    trainer = Trainer(task, train_batcher, config=cfg, outdir=args.outdir,
                      dev_batcher=dev_batcher, writer=writer, mesh=mesh,
                      multihost=multihost)
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
    log_kernel_launches()
    if mesh is not None:
        logging.info("rank %d parameter checksum: %s", rank,
                     replica_checksum(task.generator, task.discriminator))
    if trainer.preempted:
        # EX_TEMPFAIL: a graceful preemption with a resumable checkpoint
        logging.info("preempted; checkpoint saved - exiting 75")
        sys.exit(75)
    logging.info("finished training.")


if __name__ == "__main__":
    main()
