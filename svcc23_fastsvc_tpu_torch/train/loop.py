"""Host-side training loop around `train.gan.FastSVCTrainTask` and
`train.b02.B02TrainTask`.

Counterpart of `svcc23_fastsvc_tpu/train/loop.py::Trainer`, on one device
or as one rank of a data group (`mesh=`):
a step loop that picks `gen_step` up to `discriminator_train_start_steps`
and `gan_step` after it, the warm-up fast-forward past
`generator_train_start_steps`, log, eval and save intervals,
`train_max_steps`, resume, the packed wire format, intermediate wav / png
dumps after eval (`num_save_intermediate_results`), scalars to an optional
tensorboard writer, a `torch.profiler` trace of the run (`profile_dir`),
and a graceful SIGTERM (checkpoint at the next call boundary, `preempted`
set, the CLI exits 75).

`steps_per_call` K > 1 runs K steps a call for either task, as the JAX
trainer does (`lax.scan` there): calls split at the log, eval and save
intervals and at the phase switch (`_next_boundary`, the JAX rule), k
batches stacked and packed and sent in one transfer, and the log takes
each call's mean over its steps. On the card a call is one replay of a
captured CUDA graph (`train.graphs.StepGraphs`); on the CPU, the task's
`multi_step` eager loop. A call of one step, and every step when K = 1, is
the eager `gen_step` / `gan_step`. Preemption is honoured between calls.

Batches come from a batcher that queues ahead itself (`is_prefetching`:
the native producer, a `BatcherPool`) or else through a
`data.prefetch.PrefetchIterator` of depth max(2, 2K) that the trainer
starts at its first step, as the JAX trainer wraps its batchers. The
iterator records the batcher's random state with each batch, so a
checkpoint saves the state of the first batch not yet taken, and `run`
puts the batcher back there when it ends: `--resume` stays exact with the
thread running ahead.

Under a data group (`parallel.make_mesh`) each process is one rank: the
trainer gives every rank rank 0's state (`replicate`) and rank r's noise
generator the seed + r, sets the task's `dp_group` (the one step that
JAX's `dp_impl` gspmd and shard_map both map to here), and feeds each
call this rank's rows: a slice of the global batch its batcher draws
(`shard_batch`), or with `multihost` the local batch its own batcher
draws (`global_batch`). Rank 0 alone writes checkpoints, and every rank
waits at a barrier until the file is whole; the intermediate dumps are
skipped under `multihost`, as in JAX; the SIGTERM flag is combined
across the ranks (MAX, on a host-side gloo group) at every call
boundary, so all ranks stop and save at the same step and none is left
waiting inside a collective.

CUDA runs asynchronously, so each interval's rate is taken after the
metrics' transfer has drained the device queue: steps/s and audio-s/s
(frames/s for a batcher of `max_frames`-frame utterances, B02's) are
wall-clock throughput.
"""

from __future__ import annotations

import inspect
import logging
import os
import signal as _signal
import time
from collections import defaultdict
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..data.prefetch import PrefetchIterator
from ..data.wire import WirePacker, to_device
from ..ops.conv import decide_conv_lowering
from ..parallel.distributed import global_batch, global_stacked_batch
from ..parallel.mesh import (
    dp_impl,
    host_group,
    mesh_rank,
    mesh_size,
    replicate,
    shard_batch,
    shard_stacked_batch,
)
from .checkpoint import (
    checkpoint_path,
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from .graphs import StepGraphs


def _stack(batches: list) -> dict:
    """Host batches stacked on a new leading axis, field by field (a copy:
    a producer's slot views may be released after it)."""
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def _plot_waveforms_png(path, gen, ref, sr):
    """Waveforms and log spectrograms of a generated and a reference
    utterance side by side (the JAX trainer's listening-check figure)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 2, figsize=(10, 6))
    t = np.arange(len(ref)) / sr
    for col, (name, y) in enumerate((("generated", gen), ("reference", ref))):
        axes[0, col].plot(t[:len(y)], y, linewidth=0.4)
        axes[0, col].set_title(name)
        axes[0, col].set_xlabel("s")
        n_fft, hop = 1024, 256
        if len(y) >= n_fft:
            frames = 1 + (len(y) - n_fft) // hop
            idx = np.arange(n_fft)[None, :] + hop * np.arange(frames)[:, None]
            spec = np.abs(np.fft.rfft(np.asarray(y)[idx] * np.hanning(n_fft),
                                      axis=1))
            axes[1, col].imshow(
                20 * np.log10(np.maximum(spec, 1e-5)).T, origin="lower",
                aspect="auto", cmap="magma",
                extent=[0, frames * hop / sr, 0, sr / 2 / 1000])
            axes[1, col].set_ylabel("kHz")
            axes[1, col].set_xlabel("s")
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


class Trainer:
    def __init__(self, task, train_batcher, *, config: dict, outdir: str,
                 dev_batcher=None, writer=None, mesh=None,
                 multihost: bool = False):
        self.task = task
        self.train_batcher = train_batcher
        self.dev_batcher = dev_batcher
        self.config = config
        self.outdir = outdir
        # a tensorboard SummaryWriter (or anything with add_scalar), or None
        self.writer = writer
        self.device = task.device
        # decide the conv lowering before the first step, as the JAX
        # trainer does: in "auto" mode the fused-conv probe runs (and
        # raises when it fails) here, not inside a step
        self.conv_lowering = decide_conv_lowering(self.device)
        logging.info("conv lowering: %s", self.conv_lowering)
        self.mesh = mesh
        self.multihost = multihost and mesh is not None
        self.rank, self.world = mesh_rank(mesh), mesh_size(mesh)
        self._host = host_group(mesh)
        if mesh is not None:
            logging.info("data parallel (dp_impl %s): rank %d of %d",
                         dp_impl(config), self.rank, self.world)
            replicate(task, mesh)
            task.dp_group = mesh
            self._seed_rank_noise()
        # K steps a call: on the card one captured CUDA graph per (phase,
        # k, batch layout), on the CPU an eager loop (train/graphs.py)
        self.steps_per_call = max(int(config.get("steps_per_call", 1)), 1)
        self._train_iter = None  # made at the first step (`_next_batch`)
        self._graphs = (StepGraphs(task) if self.steps_per_call > 1
                        and self.device.type == "cuda" else None)
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
        # the steps each call ran, in order
        self.call_sizes: list = []
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

    def _agree(self, flag: bool) -> bool:
        """`flag` on any rank (a MAX all-reduce on the host group)."""
        if self.mesh is None:
            return flag
        t = torch.tensor([int(flag)])
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._host)
        return bool(t.item())

    def _seed_rank_noise(self):
        """Rank r > 0 draws its own noise: seed + r at the start, and after
        a resume (which loads rank 0's state everywhere) seed + r + W *
        step; rank 0 keeps the single-process stream."""
        rng = self.task.rng
        if rng is not None and self.rank > 0:
            rng.manual_seed(rng.initial_seed() + self.rank
                            + self.world * self.task.step)

    def _local_rows(self, batch: dict, stacked: bool = False) -> dict:
        """This rank's rows of a host batch (or K stacked ones)."""
        if self.mesh is None:
            return batch
        if self.multihost:
            return (global_stacked_batch if stacked else global_batch)(
                batch, self.mesh)
        return (shard_stacked_batch if stacked else shard_batch)(
            batch, self.mesh)

    # -- checkpoints -------------------------------------------------------

    def _batcher_rng(self):
        """The batcher's random state at the first batch not yet taken."""
        if isinstance(self._train_iter, PrefetchIterator):
            return self._train_iter.state
        rng = getattr(self.train_batcher, "rng", None)
        return None if rng is None else rng.bit_generator.state

    def _next_batch(self):
        if self._train_iter is None:
            b = self.train_batcher
            if getattr(b, "is_prefetching", False):
                self._train_iter = iter(b)
            else:
                rng = getattr(b, "rng", None)
                bg = None if rng is None else rng.bit_generator
                self._train_iter = PrefetchIterator(
                    b, depth=max(2, 2 * self.steps_per_call),
                    state=None if bg is None else (lambda: bg.state),
                    restore=None if bg is None else
                    (lambda st: setattr(bg, "state", st)))
        return next(self._train_iter)

    def close(self):
        """Stop the prefetch thread, the batcher put back at the first
        batch not taken (a batcher that prefetches itself is the caller's
        to close)."""
        if isinstance(self._train_iter, PrefetchIterator):
            self._train_iter.close()
        self._train_iter = None

    def resume(self, path: Optional[str] = None, *, params_only=False):
        """Restore from a checkpoint file, or the latest under a directory
        (the outdir by default)."""
        self.close()  # the batcher's state is about to be set
        path = path or self.outdir
        if path and not path.endswith(".pkl"):
            path = latest_checkpoint(path)
        if path is None:
            logging.info("no checkpoint found; starting fresh")
            return
        rng = load_checkpoint(path, self.task, params_only=params_only)
        if rng and rng.get("batcher") is not None and \
                getattr(self.train_batcher, "rng", None) is not None \
                and not (self.multihost and self.rank > 0):
            # the checkpoint holds rank 0's batcher; under multihost rank
            # r > 0 draws its own stream, which starts again at its seed
            self.train_batcher.rng.bit_generator.state = rng["batcher"]
        self._seed_rank_noise()
        logging.info("%s %s (step %d)", "loaded params from" if params_only
                     else "resumed from", path, self.task.step)

    def save(self, barrier: bool = True):
        """Write the checkpoint of this step (rank 0 only under a data
        group; with `barrier` the other ranks wait until it is whole)."""
        path = checkpoint_path(self.outdir, self.task.step)
        if self.rank == 0:
            save_checkpoint(path, self.task, batcher_rng=self._batcher_rng())
            logging.info("saved checkpoint at step %d: %s", self.task.step,
                         path)
        if barrier and self.mesh is not None:
            dist.barrier(group=self._host)
        return path

    # -- loop ------------------------------------------------------------

    def run(self):
        cfg = self.config
        max_steps = cfg["train_max_steps"]
        d_start = cfg["discriminator_train_start_steps"]
        g_start = cfg.get("generator_train_start_steps", 0)
        log_iv = cfg["log_interval_steps"]
        eval_iv = cfg["eval_interval_steps"]
        save_iv = cfg["save_interval_steps"]
        waits = dict.fromkeys(("data", "step", "drain", "eval", "save"), 0.0)
        step = self.task.step
        # the warm-up fast-forward of the JAX trainer: neither player trains
        # until step > min(g_start, d_start), so the idle steps are skipped
        # at once. Only the step count jumps: the optimizers' counts (RAdam's
        # step, StepLR's epoch) stay, as optax's do in JAX.
        if g_start > 0 and step <= min(g_start, d_start):
            target = min(min(g_start, d_start) + 1, max_steps)
            logging.info("warm-up fast-forward: step %d -> %d", step, target)
            self.task.step = step = target
        t_last, steps_last = time.time(), step

        def _next_boundary(s):
            # steps until the next interval or phase boundary (JAX's rule)
            cands = [max_steps - s]
            for iv in (log_iv, eval_iv, save_iv):
                cands.append(iv - (s % iv))
            if s <= d_start:
                cands.append(d_start - s + 1)
            return max(min(cands), 1)

        profiler = self._start_profiler(cfg.get("profile_dir"))
        finished = False
        try:
            while step < max_steps:
                if self._agree(self._preempt_requested):
                    self.preempted = True
                    logging.warning("preempted at step %d; saving and "
                                    "exiting (resume with --resume)", step)
                    break
                k = min(self.steps_per_call, _next_boundary(step))
                phase = "gan" if step > d_start else "gen"
                t0 = time.time()
                if k > 1:
                    batches = self._pack(self._local_rows(_stack(
                        [self._next_batch() for _ in range(k)]), True))
                    if self._graphs is not None:
                        staged = self._graphs.stage(phase, batches)
                    else:
                        staged = to_device(batches, self.device)
                    waits["data"] += time.time() - t0
                    t0 = time.time()
                    if self._graphs is not None:
                        metrics = self._graphs.replay(staged)
                    else:
                        metrics = self.task.multi_step(phase, staged)
                    # the mean over the call's steps, as the JAX trainer
                    # logs it
                    metrics = {n: v.mean(0) for n, v in metrics.items()}
                else:
                    batch = self._pack(self._local_rows(self._next_batch()))
                    batch = to_device(batch, self.device)
                    waits["data"] += time.time() - t0
                    t0 = time.time()
                    metrics = getattr(self.task, f"{phase}_step")(batch)
                waits["step"] += time.time() - t0
                step = self.task.step
                self.call_sizes.append(k)
                self._accumulate(metrics)

                if step % log_iv == 0:
                    # drain first, so the interval's time is the device's too
                    t0 = time.time()
                    # one device-to-host copy per call
                    host = [dict(zip(m, torch.stack(list(m.values())).tolist()))
                            for m in self._pending]
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    waits["drain"] = time.time() - t0
                    dt = time.time() - t_last
                    sps = (step - steps_last) / dt if dt > 0 else 0.0
                    frames = getattr(self.train_batcher, "max_frames", None)
                    if frames is None:
                        rate = {"audio_s_per_s": sps * cfg["batch_size"]
                                * cfg["batch_length"] / cfg["sampling_rate"]}
                    else:
                        rate = {"frames_per_s": sps * cfg["batch_size"]
                                * frames}
                    self._flush_logs(step, host, {
                        "steps_per_s": sps,
                        **rate,
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
                    self._save_intermediate(step)
                    waits["eval"] += time.time() - t0
                if step % save_iv == 0:
                    t0 = time.time()
                    self.save()
                    waits["save"] += time.time() - t0
            finished = True
        finally:
            if profiler is not None:
                self._stop_profiler(profiler)
            # the batcher back at the first batch not taken, then the
            # crash-safe save of the reference trainer (no barrier after a
            # failure: the other ranks may never reach it)
            self.close()
            self.save(barrier=finished)

    # -- profiling ---------------------------------------------------------

    def _start_profiler(self, profile_dir):
        """A `torch.profiler` session over the run (`profile_dir`), host
        activity and, on the card, the kernels."""
        if not profile_dir:
            return None
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        prof.trace_path = os.path.join(
            profile_dir, f"trace-step{self.task.step}.json")
        return prof

    def _stop_profiler(self, prof):
        prof.stop()
        os.makedirs(os.path.dirname(prof.trace_path), exist_ok=True)
        prof.export_chrome_trace(prof.trace_path)
        logging.info("profile written to %s", prof.trace_path)

    # -- logging ---------------------------------------------------------

    def _accumulate(self, metrics):
        self._pending.append(metrics)

    def _flush_logs(self, step, host, extra):
        items = defaultdict(float)
        for m in host:
            for k, v in m.items():
                items[k] += v / len(host)
        items.update(extra)
        self.history.append({"step": step, **items})
        logging.info("step %d: %s", step, ", ".join(
            f"{k}={v:.4f}" for k, v in sorted(items.items())))
        if self.writer is not None:
            for k, v in items.items():
                self.writer.add_scalar(f"train/{k}", v, step)
        self._pending = []

    def _evaluate(self, step):
        totals, n = defaultdict(float), 0
        # the FastSVC eval scores the adversarial terms once D trains; the
        # B02 eval has no such switch (the JAX Trainer's rule)
        kw = {}
        if "with_adv" in inspect.signature(self.task.eval_step).parameters:
            kw["with_adv"] = step > self.config.get(
                "discriminator_train_start_steps", 0)
        for batch in self.dev_batcher:
            metrics = self.task.eval_step(to_device(batch, self.device), **kw)
            for k, v in metrics.items():
                totals[k] += float(v)
            n += 1
            if n >= self.config.get("eval_batches", 4):
                break
        items = {k: v / max(n, 1) for k, v in totals.items()}
        logging.info("eval @ %d: %s", step, ", ".join(
            f"{k}={v:.4f}" for k, v in sorted(items.items())))
        if self.writer is not None:
            for k, v in items.items():
                self.writer.add_scalar(f"eval/{k}", v, step)

    def _save_intermediate(self, step):
        """Generated and reference wavs (and a png of both) of the first
        `num_save_intermediate_results` utterances of a dev batch, under
        `predictions/step{step}/`, as the JAX trainer dumps them. The
        forward is the task's `predict`: eager, in its compute dtype, the
        excitation noise from a generator seeded by the step. A task
        without one (B02) dumps nothing, and a failed dump only warns: a
        dump never stops training. Without matplotlib the wavs are still
        written."""
        n = self.config.get("num_save_intermediate_results", 0)
        if not n or not hasattr(self.task, "predict"):
            return
        if self.multihost:
            # the dump runs outside the collective step; the JAX trainer
            # skips it rather than strand the other processes
            return
        try:
            from ..bin.common import write_wav

            batch = next(iter(self.dev_batcher))
            y_hat = self.task.predict(to_device(batch, self.device),
                                      seed=step).cpu().numpy()
            outdir = os.path.join(self.outdir, "predictions", f"step{step}")
            os.makedirs(outdir, exist_ok=True)
            sr = self.config.get("sampling_rate", 16000)
            pairs = []
            for i in range(min(n, y_hat.shape[0])):
                ref = np.asarray(batch["audio"][i, :, 0])
                write_wav(os.path.join(outdir, f"{i}_gen.wav"),
                          y_hat[i, :, 0], sr)
                write_wav(os.path.join(outdir, f"{i}_ref.wav"), ref, sr)
                pairs.append((i, y_hat[i, :, 0], ref))
        except Exception as e:  # a dump never stops training
            logging.warning("intermediate dump failed: %s", e, exc_info=True)
            return
        try:
            for i, gen, ref in pairs:
                _plot_waveforms_png(os.path.join(outdir, f"{i}.png"), gen,
                                    ref, sr)
        except Exception as e:  # matplotlib may be absent
            logging.warning("no waveform pngs (%s); the wavs are written", e)
