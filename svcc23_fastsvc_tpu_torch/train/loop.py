"""Host-side training loop around `train.gan.FastSVCTrainTask`.

Counterpart of `svcc23_fastsvc_tpu/train/loop.py::Trainer`, the part the
FastSVC recipe runs on one device: a step loop that picks `gen_step` up to
`discriminator_train_start_steps` and `gan_step` after it, log, eval and
save intervals, `train_max_steps`, resume, the packed wire format, and a
graceful SIGTERM (checkpoint at the next step boundary, `preempted` set,
the CLI exits 75).

The port runs one step per call: the JAX package's `steps_per_call` (K
steps in one `lax.scan` program) has no counterpart yet, and a config that
sets it is logged as running one step per call. Scalars go to the log
only (no tensorboard yet). The batcher runs in the
loop's thread (no prefetch thread), so its random state at a checkpoint is
exactly that of the steps taken.

CUDA runs asynchronously, so each interval's rate is taken after the
metrics' transfer has drained the device queue: steps/s and audio-s/s are
wall-clock throughput.
"""

from __future__ import annotations

import logging
import signal as _signal
import time
from collections import defaultdict
from typing import Optional

import torch

from ..data.wire import WirePacker, to_device
from ..ops.conv import decide_conv_lowering
from .checkpoint import (
    checkpoint_path,
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)


class Trainer:
    def __init__(self, task, train_batcher, *, config: dict, outdir: str,
                 dev_batcher=None):
        self.task = task
        self.train_batcher = train_batcher
        self.dev_batcher = dev_batcher
        self.config = config
        self.outdir = outdir
        self.device = task.device
        # decide the conv lowering before the first step, as the JAX
        # trainer does: in "auto" mode the fused-conv probe runs (and
        # raises when it fails) here, not inside a step
        self.conv_lowering = decide_conv_lowering(self.device)
        logging.info("conv lowering: %s", self.conv_lowering)
        if int(config.get("steps_per_call", 1)) > 1:
            logging.info("steps_per_call %s: the port runs one step per "
                         "call", config["steps_per_call"])
        # the packed wire is exact only when the step casts to bf16 anyway
        wf = str(config.get("wire_format", "f32"))
        if wf not in ("f32", "packed"):
            raise ValueError(f"unknown wire_format {wf!r}")
        if wf == "packed":
            if str(config.get("compute_dtype", "")) not in ("bfloat16",
                                                            "bf16"):
                raise ValueError(
                    "wire_format: packed requires compute_dtype bfloat16 "
                    "(bf16 ppg/lft on the wire are only exact when the "
                    "step casts to bf16 anyway)")
            self._pack = WirePacker(hop_size=int(config["hop_size"]))
            logging.info("transfer wire format: packed")
        else:
            self._pack = lambda b: b
        self._pending = []
        self._preempt_requested = False
        self.preempted = False
        # what each log interval logged: step, mean losses, rates, waits
        self.history: list = []

    # -- preemption --------------------------------------------------------

    def install_preemption_handler(self, signals=(_signal.SIGTERM,)):
        """On SIGTERM, checkpoint and stop at the next step boundary: the
        handler only sets a flag, `run` saves and returns with `preempted`
        set, and the CLI exits 75 (EX_TEMPFAIL)."""

        def _handler(signum, frame):
            logging.warning("signal %d: checkpoint and exit at the next "
                            "step boundary", signum)
            self._preempt_requested = True

        for s in signals:
            _signal.signal(s, _handler)

    # -- checkpoints -------------------------------------------------------

    def _batcher_rng(self):
        rng = getattr(self.train_batcher, "rng", None)
        return None if rng is None else rng.bit_generator.state

    def resume(self, path: Optional[str] = None, *, params_only=False):
        """Restore from a checkpoint file, or the latest under a directory
        (the outdir by default)."""
        path = path or self.outdir
        if path and not path.endswith(".pkl"):
            path = latest_checkpoint(path)
        if path is None:
            logging.info("no checkpoint found; starting fresh")
            return
        rng = load_checkpoint(path, self.task, params_only=params_only)
        if rng and rng.get("batcher") is not None and \
                getattr(self.train_batcher, "rng", None) is not None:
            self.train_batcher.rng.bit_generator.state = rng["batcher"]
        logging.info("%s %s (step %d)", "loaded params from" if params_only
                     else "resumed from", path, self.task.step)

    def save(self):
        path = checkpoint_path(self.outdir, self.task.step)
        save_checkpoint(path, self.task, batcher_rng=self._batcher_rng())
        logging.info("saved checkpoint at step %d: %s", self.task.step, path)
        return path

    # -- loop ------------------------------------------------------------

    def run(self):
        cfg = self.config
        max_steps = cfg["train_max_steps"]
        d_start = cfg["discriminator_train_start_steps"]
        log_iv = cfg["log_interval_steps"]
        eval_iv = cfg["eval_interval_steps"]
        save_iv = cfg["save_interval_steps"]
        if cfg.get("generator_train_start_steps", 0):
            raise NotImplementedError(
                "generator_train_start_steps > 0 is not ported yet")
        waits = dict.fromkeys(("data", "step", "drain", "eval", "save"), 0.0)
        step = self.task.step
        t_last, steps_last = time.time(), step
        try:
            while step < max_steps:
                if self._preempt_requested:
                    self.preempted = True
                    logging.warning("preempted at step %d; saving and "
                                    "exiting (resume with --resume)", step)
                    break
                t0 = time.time()
                batch = self._pack(self.train_batcher.sample_batch())
                batch = to_device(batch, self.device)
                waits["data"] += time.time() - t0
                t0 = time.time()
                if step > d_start:
                    metrics = self.task.gan_step(batch)
                else:
                    metrics = self.task.gen_step(batch)
                waits["step"] += time.time() - t0
                step = self.task.step
                self._pending.append(metrics)

                if step % log_iv == 0:
                    # drain first, so the interval's time is the device's too
                    t0 = time.time()
                    # one device-to-host copy per step
                    host = [dict(zip(m, torch.stack(list(m.values())).tolist()))
                            for m in self._pending]
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    waits["drain"] = time.time() - t0
                    dt = time.time() - t_last
                    sps = (step - steps_last) / dt if dt > 0 else 0.0
                    audio_s = (cfg["batch_size"] * cfg["batch_length"]
                               / cfg["sampling_rate"])
                    self._flush_logs(step, host, {
                        "steps_per_s": sps,
                        "audio_s_per_s": sps * audio_s,
                        "data_wait_s": waits["data"],
                        "step_wait_s": waits["step"],
                        "drain_s": waits["drain"],
                        "eval_s": waits["eval"],
                        "save_s": waits["save"],
                    })
                    t_last, steps_last = time.time(), step
                    waits = dict.fromkeys(waits, 0.0)
                if self.dev_batcher is not None and step % eval_iv == 0:
                    t0 = time.time()
                    self._evaluate(step)
                    waits["eval"] += time.time() - t0
                if step % save_iv == 0:
                    t0 = time.time()
                    self.save()
                    waits["save"] += time.time() - t0
        finally:
            # the crash-safe save of the reference trainer
            self.save()

    # -- logging ---------------------------------------------------------

    def _flush_logs(self, step, host, extra):
        items = defaultdict(float)
        for m in host:
            for k, v in m.items():
                items[k] += v / len(host)
        items.update(extra)
        self.history.append({"step": step, **items})
        logging.info("step %d: %s", step, ", ".join(
            f"{k}={v:.4f}" for k, v in sorted(items.items())))
        self._pending = []

    def _evaluate(self, step):
        totals, n = defaultdict(float), 0
        with_adv = step > self.config.get("discriminator_train_start_steps", 0)
        for batch in self.dev_batcher:
            metrics = self.task.eval_step(to_device(batch, self.device),
                                          with_adv=with_adv)
            for k, v in metrics.items():
                totals[k] += float(v)
            n += 1
            if n >= self.config.get("eval_batches", 4):
                break
        items = {k: v / max(n, 1) for k, v in totals.items()}
        logging.info("eval @ %d: %s", step, ", ".join(
            f"{k}={v:.4f}" for k, v in sorted(items.items())))
