#!/usr/bin/env python3
"""Drive the PyTorch port's FastSVC decode and training paths, the B02
vocoder's synthesis and the B02 acoustic model's decode and training on one
H100, each fused-chain mode and the fused-conv switch too, FastSVC and B02
training at K steps a call as captured CUDA graphs, the FastSVC and B02
front ends (wavs to features to conversion), the recipe's batch loader,
the HiFiGAN discriminator and the trainer's options, both recipe drivers
through the port's CLIs, every CLI a process of its own, and FastSVC
training across processes (data parallelism) on the one card.

    python3 chip_smoke.py        # from the repository root, on a CUDA machine

Phases, each printed on one line with its elapsed seconds:

1. device: require CUDA; print the card's name and power limit.
2. build: compile `svcc23_fastsvc_tpu_torch/csrc/*.cu` with nvcc (sm_90a);
   where the toolkit has cuobjdump, count the HMMA instructions of every
   window-conv, wgrad, fused-conv backward, gated-block, chain and
   down-chain instance and require some in each mma variant (the window
   convs', #6's, the blocks', the chain's and the down chain's).
3. kernels: each kernel against its plain PyTorch version, in f32 (TF32
   off) and bf16: the forward at the decode shapes of a 400-frame batch of
   8, dx and wgrad at the training shapes of the recipe's batch (32 x 16000
   samples), wgrad twice bit for bit; the sine (one launch, no scratch)
   within 1e-6 of its plain version at amp 0.1, two calls bit for bit and
   one kernel a call in the profile, at (B, Tf, hop, sr) (8, 400, 160, 16
   kHz) decode, (32, 100) training, (8, 150, 160, 24 kHz) the vocoder's 8 x
   1 s, (8, 3000) a 30 s bucket, and an odd hop, Tf = 1 and Tf = 2049.
4. decode: a full-width generator (conf/fastsvc.yaml widths, random
   weights from a seed) converts 8 utterances of 4 s through `synthesize`
   at f32 and bf16; the kernel launch counts of that run are read, the
   output checked finite, and all 8 utterances of each batch held against
   the same module, in the same dtype, on the CPU (plain versions), fed
   the same excitation noise the card drew.
5. timings: decode audio-s/s, and per kernel its time, its plain version's
   time, one PyTorch library call for the same function where there is
   one, and its bound (bytes over 3.35 TB/s or operations over the dtype's
   peak, the larger); for the window-conv rows (#2-#5) also the variant
   that ran (mma, ffma, stream) and the device time of the kernel and of
   the library call (`queued_ms`: 20 calls queued behind a spin kernel,
   CUDA events), since event times of 20 calls as the host issues them
   floor at the host's cost of a call; the sine's device time and bound at
   its four timed shapes.
6. profile: under `torch.profiler`, the device time of each kernel of one
   decode batch (f32, bf16) and the device's busy share of the batch's
   wall time; the sine kernel's device time at its four timed shapes.
7. train step vs CPU (phases 7-9 with cuDNN's deterministic algorithms,
   as the training CLI sets them; the rest with cuDNN's defaults, as
   decode and synthesis leave them): the recipe's generator and MelGAN
   discriminator at
   full width (random weights from a seed), one gen_step and one gan_step,
   each from the seed's weights, on a batch of 2 x 16000 samples with an
   explicit excitation, in f32 on the card and on the CPU (plain versions)
   and in f64 on the CPU: every loss and every G and D gradient of the
   card within 4x the CPU f32's own distance from f64 (plus a margin), and
   finite updated weights. Then two gan_steps from one state on the
   recipe's batch (32 x 16000), f32 and bf16: bit-identical G and D
   gradients.
8. train: `Trainer.run` on the recipe's batch (32 x 16000 samples, an
   in-memory dataset in FastSVCDataset's layout), one step a call
   (`steps_per_call: 1`), 20 gen_steps then 20
   gan_steps, in bf16 (packed wire) and f32 (f32 wire): finite losses, the
   kernel launches of each step, steps/s and audio-s/s of each phase's
   second log interval of 10 steps (the Trainer's own rate, CUDA
   synchronized before the clock stops), peak device memory, and the last
   checkpoint reloaded into a fresh task.
9. profile: one bf16 gan_step under `torch.profiler`: device time per
   kernel and the busy share.
10. the backward kernels' times at the training shapes.
11. vocoder kernels: the adaptive (dilations 1, 8) and fixed (1, 512) block
   kernels against their plain versions at the vocoder's full widths on
   8 x 24000 samples, f32 and bf16, with their times: the variant that ran
   (mma, ffma), the event time and the device time (`queued_ms`).
12. vocoder: the B02 HN-uSFGAN generator at full width (20 adaptive, 5 noise
   and 30 filter blocks, random weights from a seed, weight norm folded)
   vocodes 8 utterances of 1 s through `bin/synthesize_b02.py::vocode` in
   f32 and bf16: exactly 20 adaptive and 35 fixed kernel launches per
   forward (and as many weight packs, reported beside them), finite
   output, utterances 0 and 7 held against the same module
   on the CPU (plain versions; bf16 within twice the CPU's own bf16-vs-f32
   distance), audio-s/s by CUDA events and the busy share.
13. vocoder chain kernel: `pd_fixed_chain` against its plain version on the
   vocoder's own weights at 8 x 24000 samples, f32 and bf16, for the noise
   net's (1, 1, 1, 1, 1) and a filter cycle's (1, 2, 4, 8, 16): its error,
   whether it equals the block kernels bit for bit, its variant and grid
   (`chain_plan`), its time and device time, its plain version's time, and
   the time and device time of the five `pd_fixed_block` launches it
   replaces.
14. vocoder with FASTSVC_PD_CHAIN=5: the same batches through `vocode`,
   exactly 20 adaptive, 4 chain and 15 fixed launches per forward, the
   output against phase 12's (f32 within 1e-5 of max |y|; bit identity
   reported) and against the CPU as in phase 12, rates and busy share
   beside phase 12's.
15. down chain: `down_chain_fwd` against its plain version on the
   generator's DownsampleBlocks at the four decode shapes (8 x 4 s) and
   the JAX A/B tool's two (batch 32), f32 and bf16, with its variant, tile
   and grid (`down_plan`), its time and device time, its plain version's
   time, and the time and device time of the three window convs and the
   residual it replaces.
16. decode with the down-chain mode on: the batches of phase 4 through
   `synthesize`, exactly 36 window-conv, 8 down-chain and 1 sine launches
   per forward, all 8 utterances against the CPU as in phase 4, the
   difference from phase 4's output, and batch times beside phase 5's.
17. fused conv: `fused_conv1d` (#5) and its one-pass backward
   `fused_conv1d_bwd` (#6) against their plain versions (2e-4 / 2e-2 of
   max |ref|) at the generator's training shapes (batch 32 x 16000, T >=
   256), two decode shapes and Tacotron2's bap conv1, f32 and bf16; two
   backward calls bit for bit; their times, the plain versions', the
   library's (F.conv1d; one torch.ops.aten.convolution_backward call for
   dx, dw and db) and the window-conv launches they displace (#2; #3 + #4);
   for both the variant that ran and the device times (`queued_ms`) of the
   kernel, the library call and the launches displaced.
18. FastSVC training with FASTSVC_PALLAS_CONV=1, after the "auto" probe
   passed on the card: phase 7 (its gan_step against CPU f64, two steps
   bit for bit) and phase 8 (`Trainer.run`, rates, launches per
   step of #5, #6 and the window convs) again, and the device time by
   kernel of one bf16 gan_step.
19. decode with the switch on: exactly 59 fused-conv, 1 window-conv (the
   384-channel FiLM conv) and 1 sine launches per forward, all 8 utterances
   against the CPU as in phase 4, batch times beside phase 5's.
20. B02 decode: the Tacotron2 at the recipe's width (random weights from a
   seed) decodes 4 utterances padded to 400 frames through
   `bin/decode_b02.py::decode_batch`, f32 and bf16, switch off and on
   (8 fused-conv launches per forward with it: bap conv1 and conv3, the six
   FiLM convs), against the CPU on the same prenet masks (f32 within 1e-3
   of max |y|, else CPU f64 with 4x CPU f32's error; bf16 within twice the
   CPU's own bf16-vs-f32 distance), frames/s; then the decoded features
   through the vocoder (`vocode`, aux 63) and the conversion's time per
   utterance.
21. K steps a call, the recipe's `steps_per_call: 8`, cuDNN deterministic as
   in phases 7-9: a captured 8-step gen call and gan call
   (`train/graphs.py`, the recipe's noise on) against 8 eager steps each
   from the same state, metrics and G, D, moments, counts and noise state
   bit for bit, bf16 (packed wire) and f32; `Trainer.run` in f32 on
   phase 8's schedule with calls of 8 and 2 (split at the log interval),
   the rates, waits and peak memory of each phase's timed interval beside
   phase 8's (phase 25 runs the recipe's bf16 at K = 8);
   one bf16 8-step gan call's device time (the replay's event time) and
   busy share beside phase 9's gan_step.
22. B02 training (the Tacotron2 and MultiSubFreqDiscriminator at
   conf/taco2.yaml's width, random weights from a seed, cuDNN
   deterministic): one gan_step on 2 x 400 frames (its G update is the
   gen_step's), f32 on the card against the CPU in f32 and f64 (phase
   7's rule) on the same dropout masks and window starts; two gan_steps
   from one state on 16 x 400 frames, f32 and bf16, gradients bit for
   bit; `Trainer.run` on an in-memory 16 x 400 dataset in B02Dataset's
   layout, 4 gen_steps then 4 gan_steps, bf16 (packed wire) and f32 with
   the switch off (#2, #3, #4 launched in every step) and, after the
   "auto" probe, bf16 with it on (#5 and #6 in every step): finite
   losses, steps/s and frames/s of each phase's second log interval of 1
   step, launches per step, peak memory, the last
   checkpoint reloaded into a fresh task and into `load_acoustic_model`;
   one bf16 gan_step's busy share under torch.profiler; #2-#6 at the bap
   stream's training shapes (batch 16) against their plain versions, with
   the kernel's, the plain version's and cuDNN's times, device times and
   the bound.
23. the front end (recipe stages 0-3), TF32 off: 8 synthetic utterances of
   4 s (one at 24 kHz, resampled on the host) written as wavs and read
   through a wav.scp; x-vector speaker embeddings (512 / 1500 widths) and
   `extract_features` (Harvest on the host; loudness and the full-width
   16-block 144-d conformer PPG on the card), both models from seeded
   weights in the reference checkpoint layouts; per-speaker
   `F0Statistics`, the `StandardScaler` fit and transform, then phase 4's
   f32 generator converts all 8 to one speaker (launch counts set to 0
   before the front end and read after the decode: 60 window convs and 1
   sine), the pass's rate and peak memory, and the card against the CPU:
   the conformer and the x-vector on 2 s and both log-mels (the linguistic stand-in's and the
   PPG's) by phase 7's rule (CPU f64, 4x the CPU f32's error), loudness
   within 1e-5 of max |y| of the CPU's, YIN's voicing on >= 99% of frames
   and F0 within 1e-4 relative.
24. the B02 recipe from wav to converted wav, TF32 off, at
   egs/svcc23/baseline02/conf/taco2.yaml's settings (24 kHz, hop 160,
   shiftms 6.667, mcep_dim 59, Harvest): 8 synthetic utterances of 4 s
   (one at 16 kHz, resampled), two speakers; phase 23's x-vector
   embeddings; `extract_b02_features` (Harvest on the host; WORLD
   analysis, loudness and HuBERT-soft at bshall's full width, from a
   seeded checkpoint in bshall's layout, on the card); the B02 scalers
   fitted and applied in memory; every utterance shifted to one speaker,
   decoded by phase 20's full-width Tacotron2 in one batch and vocoded by
   its HN-uSFGAN; mel L1 and MCD of each conversion against its source on
   the card (launch counts set to 0 before and read after: #1, #2, #8 and
   #10, nothing else), the pass's rate and peak memory, and the card
   against the CPU: HuBERT units, mcep, bap and loudness within 2x the CPU
   f32's distance from f64 or 1e-5 of max |y|, continuous log-F0 and V/UV
   equal, the decode by phase 20's rule, the vocoder on two utterances
   within 1e-3 of max |y|, mel L1 and MCD within 1e-3 relative.
25. the recipe's loader: `Trainer.run` on egs/svcc23/fastsvc1/conf/
   fastsvc.yaml as it is (bf16, packed wire, `steps_per_call: 8`), the
   schedule cut to 8 gen and 16 gan steps, the batches from the training
   CLI's `make_train_batcher` over phase 8's in-memory dataset:
   `loader_threads: 4` must build the native producer (C++ threads, the
   host g++ build) and the run must take every batch from it; then
   `loader_threads: 1` (the batcher behind the trainer's prefetch
   thread); steps/s, audio-s/s and the data wait of each's last interval.
26. B02 training at K steps a call (phase 22's width, 16 x 400 frames,
   cuDNN deterministic): captured calls, bf16 (packed wire) a 2-step gen
   call and a 4-step gan call, f32 (plain batches) a 2-step gan call,
   each against K eager steps from the same state, bit for bit (metrics,
   G and D with their batch-norm statistics, moments, counts, the draws'
   generator); the capture's seconds, the memory left reserved after it,
   a replayed call's steps/s against the eager steps' and its busy
   share.
27. the HiFiGAN MSD + MPD (the JAX model's defaults: 3 scales, periods 2,
   3, 5, 7, 11) with the recipe's generator: one gan_step held to CPU f64
   by phase 7's rule, two gan_steps from one state bit for bit (f32,
   bf16), a bf16 and an f32 gan_step on the recipe's batch with their
   launches; #2-#4 at its stride-1 convs (K = 15 at 1 -> 128, K = 5 at
   1024 -> 1024, K = 3 at 1024 -> 1; and the MelGAN discriminator's two
   512-channel ones) against their plain versions, with their times,
   device times, cuDNN's and the bound.
28. `Trainer.run` at full width, bf16 and f32, with
   `generator_train_start_steps` 4 (the count jumps to 5, two gan_steps
   run), an eval and two intermediate dumps at step 7 and a
   `profile_dir`: the calls, counts and checkpoint, the dumps' generated
   wavs equal to the task's eager `predict`, the trace's kernel records.
29. both recipe drivers on the card at once, each run as
   `python -m svcc23_fastsvc_tpu_torch.recipes.<name> --device cuda` in a
   process of its own, every stage's CLI a process too (no h5py or joblib
   on that machine: the port's own codec and stats files): FastSVC stages
   0-5 and B02 stages 0-5 and 7, phase 23's voices (2 speakers, 4 train
   and 2 dev utterances of 2-4 s), stage 0 in hash mode, stage 1 at
   `--n-jobs 2` through the local launcher, seeded conformer-PPG and
   HuBERT-soft checkpoints for the linguistic features, the recipe yamls
   as they are (full width; FastSVC bf16, K = 8, `loader_threads: 4`) with
   the schedule cut to a few steps and a checkpoint, stage 7 through a
   seeded HN-uSFGAN `.pkl`: each stage's seconds and processes, the kernel
   launches of stages 4, 5 and 7 from the CLIs' exit logs (each kernel of
   a stage's path launched), every converted wav's length and finiteness,
   and FastSVC stage 5's wavs against an in-process `decode` of the same
   checkpoint on the same dumps (equal PCM, else phase 4's bf16 bound).

30. data parallelism (`svcc23_fastsvc_tpu_torch/parallel/`) on the one
   card: (a) two ranks, each a process (`chip_smoke.py --dp-rank`), share
   it over gloo (`SVC_DIST_BACKEND=gloo`; NCCL refuses two ranks on one
   device) and run one gen_step and one gan_step, each from the seed's
   weights, on their halves of the recipe's batch (32 x 16000, f32, the
   excitation fed), against one process on the whole batch: metrics
   within 1e-4 relative; each model's update within 1e-3 relative L2 of
   one process that runs the generator on the ranks' row blocks one after
   another, and its distance from the plain one-process step beside it; the ranks' metrics and parameter checksums
   equal, each rank's launches;
   (b) one NCCL rank at the recipe's bf16 and K = 8: the gen and gan
   calls captured with their all-reduces in the graphs, bit for bit equal
   to the same captured calls without a data group, the gan replay's
   event time beside theirs; (c) `train_fastsvc --n-procs 2` as two gloo
   processes on phase 29's FastSVC dumps with its yaml at K = 1 and two
   steps: both exit 0, their parameter checksums agree, rank 0 writes the
   checkpoint, each rank's launches from its exit log. (a) also times a
   warm second step of each phase on each rank and one gloo all-reduce of
   each model's gradient size. N NCCL ranks on N cards need a machine
   with several.

The line before the last is the kernels' JSON; the last line is
`{"ok": true, "device": {...}}`, printed only when every phase passed. A
watchdog ends a hung run with a traceback and a non-zero exit.
"""

import copy
import dataclasses
import faulthandler
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

WATCHDOG_S = 1100
faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
_T0 = time.perf_counter()

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
TOL_CONV = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
TOL_DECODE = {torch.float32: 1e-3, torch.bfloat16: 5e-2}
TOL_SINE = 1e-6  # the sine kernel against its plain version, at amp 0.1
# the f32 training step on the card and on the CPU, each against the same
# step in f64 on the CPU: the card may err by 4x the CPU's own f32 error
# plus these shares of the f64 value (losses relative; gradients of each
# tensor's max |ref|, at least 1e-6 of the step's largest gradient for the
# tensors whose exact gradient is 0); the rel L2 of all of a model's
# gradients at most twice the CPU's plus TOL_TRAIN_L2
TOL_TRAIN_LOSS, TOL_TRAIN_GRAD, TOL_TRAIN_L2 = 1e-4, 1e-3, 1e-4
F32_FACTOR = 4.0
B, TF, HOP, SR = 8, 400, 160, 16000
TF_LONG = 3000  # a 30 s bucket: the sine's prefix scan is linear in frames
# (what it is, T, Cin, Cout, dilation, input leaky) at B=8, 400 frames
CONV_SHAPES = [
    ("first down block conv1", 64000, 1, 24, 1, 0.2),
    ("last up block conv3", 64000, 24, 24, 27, 0.2),
    ("up block 3 conv2", 12800, 48, 48, 9, 0.2),
    ("up block 1 conv_first", 400, 144, 192, 1, None),
    ("up block 1 fused FiLM conv", 800, 384, 384, 1, None),
]
# (what it is, T, Cin, Cout, dilation, input leaky) of the generator's
# training convs at the recipe's batch of 32 x 16000 samples
TB = 32
GRAD_SHAPES = [
    ("first down block conv1", 16000, 1, 24, 1, 0.2),
    ("last up block conv3", 16000, 24, 24, 27, 0.2),
    ("up block 3 conv2", 3200, 48, 48, 9, 0.2),
    ("up block 2 conv1", 800, 96, 96, 3, 0.2),
    ("up block 1 up_conv", 200, 192, 192, 1, 0.2),
    ("up block 1 conv_first", 100, 144, 192, 1, None),
]
# the B02 vocoder (the JAX package's default HNUSFGANGenerator, as its bench
# runs it): 24 kHz, hop 160, batch 8 x 1 s; f0 80-400 Hz, 20% unvoiced
VB, VTF, VHOP, VSR = 8, 150, 160, 24000
# the sine kernel's (B, Tf, hop, sr), timed: decode, the training batch, the
# vocoder's 8 x 1 s, a 30 s bucket; then held to its plain version only: an
# odd hop (the scalar path), one frame, a row whose tiles re-sum 2048 frames
SINE_SHAPES = [(B, TF, HOP, SR), (TB, 100, HOP, SR), (VB, VTF, VHOP, VSR),
               (B, TF_LONG, HOP, SR)]
SINE_EDGES = [(3, 77, 81, SR), (1, 1, HOP, SR), (1, 2049, HOP, SR)]
VOC_CONFIG = {
    "sampling_rate": VSR,
    "hop_size": VHOP,
    "aux_context_window": 2,
    "dense_factor": 4,
    "generator_params": {"upsample_params": {"upsample_scales": [5, 4, 4, 2]},
                         "aux_channels": 62},
    "signal_generator": {"sine_amp": 0.1, "noise_amp": 0.003,
                         "signal_types": ["sine", "noise"]},
}
# (kernel, dilation) rows timed at the vocoder's shapes
PD_ROWS = [("adaptive", 1), ("adaptive", 8), ("fixed", 1), ("fixed", 512)]
VOC_UTTS = (0, 7)  # held against the CPU
# card vs CPU in bf16: twice the CPU's own bf16-vs-f32 distance; the two
# bf16 runs differ by rounding orders about as much as each differs from
# f32 (sqrt(2) for independent errors of one size), so 2 leaves a margin
BF16_FACTOR = 2.0

# conf/fastsvc.yaml, the recipe's 16 kHz generator and excitation
CONFIG = {
    "sampling_rate": SR,
    "hop_size": HOP,
    "generator_params": {"in_channels": 144, "out_channels": 1,
                         "mid_channels": [192, 96, 48, 24],
                         "upsampling_scales": [2, 4, 4, 5],
                         "spk_emb_size": 512, "use_spk_emb": True},
    "signal_generator": {"sine_amp": 0.1, "noise_amp": 0.003,
                         "sine_f0_type": "f0", "signal_types": ["sine"]},
}


# conf/fastsvc.yaml's discriminator, losses and optimizers (build_train_task
# defaults hold the rest); the phase split and the intervals are cut to a
# few steps
LOG_STEPS = 10
TRAIN_CONFIG = {
    **CONFIG,
    "discriminator_params": {
        "in_channels": 1, "out_channels": 1, "scales": 3,
        "downsample_pooling_params": {"kernel_size": 4, "stride": 2,
                                      "padding": 1},
        "kernel_sizes": [5, 3], "channels": 16,
        "max_downsample_channels": 512, "downsample_scales": [4, 4, 4],
        "nonlinear_activation_params": {"negative_slope": 0.2},
        "use_weight_norm": True,
    },
    "lambda_adv": 2.5,
    "batch_size": TB,
    "batch_length": 16000,
    # each phase: a warm-up interval of LOG_STEPS steps, then a timed one
    "discriminator_train_start_steps": 2 * LOG_STEPS - 1,  # then gan_step
    "train_max_steps": 4 * LOG_STEPS,
    "log_interval_steps": LOG_STEPS,
    "eval_interval_steps": 100000,
    "save_interval_steps": 2 * LOG_STEPS,
}


def say(msg):
    print(f"[{time.perf_counter() - _T0:8.2f}s] {msg}", flush=True)


def require(ok, msg):
    if not ok:
        raise RuntimeError(msg)


def cuda_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, n=3, host_ops=True):
    """Device ms per call of each kernel `fn` launches (torch.profiler rows
    with device time and no host time), largest first. Without `host_ops`
    the profiler records the device's activity only, which keeps a step of
    ~10^5 launches quick to trace."""
    activities = [ProfilerActivity.CUDA]
    if host_ops:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0 and e.cpu_time_total == 0:
            out[e.key] = out.get(e.key, 0.0) + dev_us / 1e3 / n
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def queued_ms(fn, iters=20, spin_cycles=50_000_000):
    """Device ms per call of the kernels `fn` launches, back to back: the
    calls are enqueued behind a spin kernel that holds the stream until the
    host has enqueued them all, and CUDA events time them. Unlike
    `cuda_ms` this leaves out the host's cost of a call; unlike
    `device_ms` it does not rely on torch.profiler, whose kernel records
    from small sessions went missing in this long process once the large
    profiles of phases 6 and 9 had run (rows read 0). Raises if the host
    took longer to enqueue than the spin lasted."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    spin0, start, end = (torch.cuda.Event(enable_timing=True)
                         for _ in range(3))
    spin0.record()
    torch.cuda._sleep(spin_cycles)
    start.record()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_ms = (time.perf_counter() - t) * 1e3
    end.record()
    end.synchronize()
    spin_ms = spin0.elapsed_time(start)
    require(enqueue_ms < spin_ms, f"enqueue {enqueue_ms:.2f} ms outlasted "
                                  f"the {spin_ms:.2f} ms spin")
    return start.elapsed_time(end) / iters


def sass_hmma_counts(lib_path, nvcc_path):
    """HMMA instructions per conv (window conv, wgrad, fused-conv backward)
    and gated-block kernel instance in the built library, from cuobjdump
    -sass; None where the toolkit has no cuobjdump."""
    tool = os.path.join(os.path.dirname(nvcc_path), "cuobjdump")
    if not os.path.isfile(tool):
        return None
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for ln in out.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :", 1)[1].strip()
            fn = name if any(k in name for k in (
                "window_conv_", "wgrad_", "fused_bwd_", "pd_block_",
                "pd_chain_", "down_chain_")) else None
            if fn is not None:
                counts[fn] = 0
        elif fn is not None and "HMMA" in ln:
            counts[fn] += 1
    return counts


def random_f0(gen, dev, tf, b=B):
    voiced = torch.rand((b, tf), generator=gen, device=dev) > 0.2
    return torch.where(voiced,
                       80 + 320 * torch.rand((b, tf), generator=gen, device=dev),
                       torch.zeros((b, tf), device=dev))


def bound(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def recipe_dataset(n=24, seed=0):
    """In-memory utterances in FastSVCDataset's item layout (utt_id, wave,
    f0, ppg, lft, spk_emb), 2.5-4 s each: PCM16 audio and loudness held
    for each frame, as the dumps store them, so the packed wire is exact."""
    r = np.random.default_rng(seed)
    items = []
    for j in range(n):
        nf = int(r.integers(250, 400))
        t = np.arange(nf * HOP) / SR
        wave = 0.3 * np.sin(2 * np.pi * r.uniform(100, 400) * t) + \
            0.05 * r.standard_normal(nf * HOP)
        wave = np.round(np.clip(wave, -1, 1) * 32767) / 32768
        f0 = np.where(r.random(nf) > 0.2, r.uniform(80, 400, nf), 0.0)
        items.append((f"spk{j % 4}_utt{j}", wave.astype(np.float32),
                      f0.astype(np.float32),
                      r.standard_normal((nf, 144)).astype(np.float32),
                      np.repeat(0.1 * r.standard_normal(nf), HOP).astype(
                          np.float32),
                      r.standard_normal((1, 512)).astype(np.float32)))
    return items


def counted(step_fn, counters, log):
    """step_fn, appending each call's kernel launches to `log`."""
    def run(batch):
        before = [c.launches for c in counters]
        out = step_fn(batch)
        log.append([c.launches - b for c, b in zip(counters, before)])
        return out
    return run


def recording(opt_step, log):
    """An optimizer step that keeps a CPU f64 copy of the gradients it gets."""
    def run(grads):
        log.append([g.detach().double().cpu() for g in grads])
        return opt_step(grads)
    return run


def decode_vs_cpu(dev, gens, sg, inputs, rng_states, ys):
    """Each dtype's batch `ys[dtype]` against the same module on the CPU
    (plain versions), all 8 utterances; the CPU excitation is the plain sine
    plus the noise term the card drew in that batch (the noise is
    torch.randn, not ported code, and a CPU generator cannot draw the
    card's stream)."""
    from svcc23_fastsvc_tpu_torch.bin.decode_fastsvc import synthesize

    f0_in = inputs[1]
    sg0 = dataclasses.replace(sg, noise_amp=0.0)
    clean = sg0(f0_in)
    cpu_in = [v.cpu() for v in inputs]
    out = {}
    for dtype, g in gens.items():
        replay = torch.Generator(device=dev)
        replay.set_state(rng_states[dtype])
        noise = (sg(f0_in, replay) - clean).cpu()
        y_ref = synthesize(copy.deepcopy(g).cpu(),
                           lambda f, _rng, noise=noise: sg0(f) + noise,
                           *cpu_in, generator_rng=None)
        err = (ys[dtype].cpu() - y_ref).abs().max().item()
        scale = y_ref.abs().max().item()
        out[str(dtype)[6:]] = {"max_abs_err": err, "max_abs_y": scale}
        require(err <= TOL_DECODE[dtype] * scale,
                f"decode {dtype} vs CPU plain: max err {err} > "
                f"{TOL_DECODE[dtype]} x {scale}")
    return out


def hold_to_f64(losses, grads, whos):
    """Phase 7's rule: each loss and gradient of the card's f32 step within
    4x the CPU f32 step's distance from the CPU f64 step, plus a margin
    (TOL_TRAIN_*); `losses[label]` {name: value}, `grads[label]` a list of
    gradient lists (one per optimizer step, named by `whos`), for the labels
    "cpu f64", "cpu f32" and "card f32". Returns the rows it printed."""
    loss_rows = {}
    for k, ref in losses["cpu f64"].items():
        e_card = abs(losses["card f32"][k] - ref)
        e_cpu = abs(losses["cpu f32"][k] - ref)
        loss_rows[k] = (e_card / abs(ref), e_cpu / abs(ref))
        require(e_card <= F32_FACTOR * e_cpu + TOL_TRAIN_LOSS * abs(ref),
                f"train step {k}: card err {e_card}, CPU f32 err {e_cpu}, "
                f"f64 {ref}")
    grad_rows = {}
    for who, got, cpu, ref in zip(whos, grads["card f32"], grads["cpu f32"],
                                  grads["cpu f64"]):
        step_scale = max(r.abs().max().item() for r in ref)
        scales = [max(r.abs().max().item(), 1e-6 * step_scale) for r in ref]
        rel_card = [(a - r).abs().max().item() / sc
                    for a, r, sc in zip(got, ref, scales)]
        rel_cpu = [(b - r).abs().max().item() / sc
                   for b, r, sc in zip(cpu, ref, scales)]
        # per tensor: within 4x the CPU's own f32 error plus TOL_TRAIN_GRAD
        limits = [F32_FACTOR * rf + TOL_TRAIN_GRAD for rf in rel_cpu]
        for i, (rc, rf, lim) in enumerate(zip(rel_card, rel_cpu, limits)):
            require(rc <= lim, f"train step {who} gradient {i}: card err "
                               f"{rc}, CPU f32 err {rf} (of max |ref|)")
        flat = lambda xs: torch.cat([x.reshape(-1) for x in xs])  # noqa: E731
        l2_card = ((flat(got) - flat(ref)).norm() / flat(ref).norm()).item()
        l2_cpu = ((flat(cpu) - flat(ref)).norm() / flat(ref).norm()).item()
        require(l2_card <= 2 * l2_cpu + TOL_TRAIN_L2,
                f"train step {who} gradients: rel L2 card {l2_card}, CPU f32 "
                f"{l2_cpu}")
        grad_rows[who] = {
            "tensors": len(ref),
            "err / max |ref|, card: median, max": (
                float(np.median(rel_card)), max(rel_card)),
            "cpu f32: median, max": (float(np.median(rel_cpu)),
                                     max(rel_cpu)),
            "rel L2, card, cpu f32": (l2_card, l2_cpu),
            "max err / limit": max(rc / lim for rc, lim in
                                   zip(rel_card, limits)),
            "max card err / cpu f32 err": max(rc / max(rf, 1e-30) for rc, rf
                                              in zip(rel_card, rel_cpu)),
        }
    return loss_rows, grad_rows


def train_vs_cpu(dev, items, what="", config=None, steps=("gen", "gan")):
    """Phase 7 (and 18, 27): one gen_step and one gan_step (`steps`) of the
    recipe's full width (`config`, TRAIN_CONFIG by default) on the card
    against the CPU, each from the seed's weights; then two gan_steps from
    one state on the recipe's batch, f32 and bf16, with bit-identical
    gradients."""
    from svcc23_fastsvc_tpu_torch.config import build_train_task
    from svcc23_fastsvc_tpu_torch.data.collate import FastSVCBatcher
    from svcc23_fastsvc_tpu_torch.data.wire import to_device

    r = np.random.default_rng(5)
    tf2 = 16000 // HOP
    pbatch = {
        "ppg": r.standard_normal((2, tf2, 144)).astype(np.float32),
        "f0": r.uniform(80, 400, (2, tf2, 1)).astype(np.float32),
        "lft": np.repeat(0.1 * r.standard_normal((2, tf2, 1)), HOP,
                         axis=1).astype(np.float32),
        "spk_emb": r.standard_normal((2, 512)).astype(np.float32),
        "audio": (0.3 * np.sin(np.arange(16000) * 0.05)[None, :, None]
                  * np.ones((2, 1, 1))).astype(np.float32),
        "sine": (0.1 * np.sin(np.arange(16000) * 0.08)[None, :, None]
                 * np.ones((2, 1, 1))).astype(np.float32),
    }
    # each step from the same fresh state: the STFT loss's gradient is so
    # ill-conditioned at this size that a 1e-7 relative change of the weights
    # moves it by ~1% (f64, CPU), so after one f32 update the card's and the
    # CPU's next gradients are no longer comparable
    config = TRAIN_CONFIG if config is None else config
    losses, grads = {}, {}
    for phase in steps:
        for label, where, dtype in (("cpu f64", "cpu", torch.float64),
                                    ("cpu f32", "cpu", torch.float32),
                                    ("card f32", dev, torch.float32)):
            task = build_train_task(config, device=where, seed=3)
            task.generator.to(dtype)
            task.discriminator.to(dtype)
            log = grads.setdefault(label, [])
            task.g_opt.step = recording(task.g_opt.step, log)
            task.d_opt.step = recording(task.d_opt.step, log)
            b = {k: v.to(dtype) for k, v in to_device(pbatch, where).items()}
            m = getattr(task, f"{phase}_step")(b)
            params = [p.detach() for mod in (task.generator,
                                             task.discriminator)
                      for p in mod.parameters()]
            require(all(torch.isfinite(p).all().item() for p in params),
                    f"updated weights, {phase} {label}: not finite")
            losses.setdefault(label, {}).update(
                {f"{phase} {k}": float(v) for k, v in m.items()})
            del task
    whos = (("G gen",) if "gen" in steps else ()) + (
        ("G gan", "D gan") if "gan" in steps else ())
    loss_rows, grad_rows = hold_to_f64(losses, grads, whos)
    say(f"{what}train step vs CPU f64 (card f32 and CPU f32, B=2 x 16000, "
        f"{' and '.join(steps)} step each from the seed's weights): loss rel "
        f"errs (card, cpu f32) {loss_rows}")
    say(f"  gradients: {grad_rows}; card losses {losses['card f32']}")

    # two gan_steps from one state give the same gradients, bit for bit
    rbatch = to_device(FastSVCBatcher(items, batch_size=TB,
                                      batch_length=16000, hop_size=HOP,
                                      seed=3).sample_batch(), dev)
    repeat = {}
    for dt_name in ("float32", "bfloat16"):
        runs = []
        for _ in range(2):
            task = build_train_task({**config, "compute_dtype": dt_name},
                                    device=dev, seed=3)
            log = []
            task.g_opt.step = recording(task.g_opt.step, log)
            task.d_opt.step = recording(task.d_opt.step, log)
            task.gan_step(rbatch)
            runs.append(log)
            del task
        differ = {who: sum(not torch.equal(a, b) for a, b in zip(ga, gb))
                  for who, ga, gb in zip(("G", "D"), *runs)}
        repeat[dt_name] = differ
        require(differ == {"G": 0, "D": 0},
                f"gan_step {dt_name} twice from one state: gradient tensors "
                f"that differ {differ}")
    say(f"{what}gan_step twice from one state (B={TB} x 16000): gradient "
        f"tensors that differ {repeat} (cudnn.deterministic "
        f"{torch.backends.cudnn.deterministic})")
    return {"losses": loss_rows, "grads": grad_rows, "repeat": repeat}


def trainer_run(dev, items, counters, what=""):
    """Phase 8 (and 18): `Trainer.run` on the recipe's batch, 20 gen_steps
    then 20 gan_steps, in bf16 (packed wire) and f32; the rates of each
    phase's timed interval and the launches of each counter, set to 0 just
    before."""
    from svcc23_fastsvc_tpu_torch.config import build_train_task
    from svcc23_fastsvc_tpu_torch.data.collate import FastSVCBatcher
    from svcc23_fastsvc_tpu_torch.train.checkpoint import load_checkpoint
    from svcc23_fastsvc_tpu_torch.train.loop import Trainer

    names = ", ".join(c.__name__ for c in counters)
    for c in counters:
        c.launches = 0
    train_rates, step_launches = {}, {}
    workdir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        for dt_name, wire in (("bfloat16", "packed"), ("float32", "f32")):
            cfg = {**TRAIN_CONFIG, "compute_dtype": dt_name,
                   "wire_format": wire, "steps_per_call": 1}
            task = build_train_task(cfg, device=dev, seed=7)
            log = []
            task.gen_step = counted(task.gen_step, counters, log)
            task.gan_step = counted(task.gan_step, counters, log)
            batcher = FastSVCBatcher(items, batch_size=TB,
                                     batch_length=16000, hop_size=HOP,
                                     seed=1)
            outdir = os.path.join(workdir, dt_name)
            trainer = Trainer(task, batcher, config=cfg, outdir=outdir)
            torch.cuda.reset_peak_memory_stats()
            trainer.run()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            rates = trainer.history  # one entry per LOG_STEPS steps
            require(all(np.isfinite(v) for x in rates for v in x.values()),
                    f"{dt_name}: non-finite losses {rates}")
            n_steps = 4 * LOG_STEPS
            require(task.step == n_steps and len(rates) == 4,
                    f"{dt_name}: {task.step} steps, {len(rates)} logged")
            # a fresh task from the last checkpoint holds the same weights
            fresh = build_train_task(cfg, device=dev, seed=99)
            load_checkpoint(
                os.path.join(outdir, f"checkpoint-{n_steps}steps.pkl"), fresh)
            for a, b in ((task.generator, fresh.generator),
                         (task.discriminator, fresh.discriminator)):
                for (k, v), w in zip(a.state_dict().items(),
                                     b.state_dict().values()):
                    require(torch.equal(v, w), f"checkpoint reload: {k}")
            require(fresh.step == n_steps and fresh.g_opt.count == n_steps
                    and fresh.d_opt.count == n_steps // 2,
                    "checkpoint reload: counts")
            for phase, warm, timed in (("gen", 0, 1), ("gan", 2, 3)):
                train_rates[f"{phase} {dt_name}"] = {
                    "steps_per_s": rates[timed]["steps_per_s"],
                    "audio_s_per_s": rates[timed]["audio_s_per_s"],
                    "warm_up_interval_steps_per_s":
                        rates[warm]["steps_per_s"],
                    "data_wait_s": rates[timed]["data_wait_s"],
                    "step_wait_s": rates[timed]["step_wait_s"],
                    "peak_mem_gib": peak / 2 ** 30,
                    f"launches_per_step ({names})": log[LOG_STEPS * timed],
                }
            step_launches[dt_name] = log
            say(f"{what}train {dt_name} ({wire} wire): mean losses to step "
                + "; ".join(f"{x['step']}: G {x['generator_loss']:.4f}"
                            + (f" D {x['discriminator_loss']:.4f}"
                               if "discriminator_loss" in x else "")
                            for x in rates))
            del task, fresh, trainer
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    half = 2 * LOG_STEPS  # the gen_steps, then the gan_steps
    for log in step_launches.values():
        require(all(row == log[0] for row in log[:half])
                and all(row == log[half] for row in log[half:]),
                f"launches differ between steps of a phase: {log}")
        require(all(n > 0 for n in log[0]) and all(n > 0 for n in log[half]),
                f"a kernel was not launched in a training step: {log}")
    train_launches = {c.__name__: c.launches for c in counters}
    say(f"{what}train main path: launches {train_launches}")
    for k, v in train_rates.items():
        say(f"{what}train {k}: {v}")
    return train_rates, train_launches


KSTEPS = 8  # conf/fastsvc.yaml's steps_per_call


def _differing(a, b):
    """Tensors of two FastSVCTrainTasks' training state that differ (an
    optimizer that has not stepped gets its zero moments first, as its first
    step would, since a capture makes them)."""
    for opt in (a.g_opt, a.d_opt, b.g_opt, b.d_opt):
        opt._init_state()
    n = {who: sum(not torch.equal(u, v) for u, v in zip(
        x.state_dict().values(), y.state_dict().values()))
        for who, x, y in (("G", a.generator, b.generator),
                          ("D", a.discriminator, b.discriminator))}
    n["moments"] = sum(not torch.equal(u, v)
                       for o, q in ((a.g_opt, b.g_opt), (a.d_opt, b.d_opt))
                       for u, v in zip(o.mu + o.nu, q.mu + q.nu))
    n["noise generator"] = int(not torch.equal(a.rng.get_state(),
                                               b.rng.get_state()))
    n["counts"] = int((a.step, a.g_opt.count, a.d_opt.count)
                      != (b.step, b.g_opt.count, b.d_opt.count))
    return n


def k_step_phase(dev, items, counters, rates_1, step_profile):
    """Phase 21: the recipe's steps_per_call 8 (K steps a call, each call
    one replay of a captured CUDA graph, `train/graphs.py`), full width, the
    recipe's noise on, cuDNN deterministic as in phases 7-9: (1) a captured
    8-step gen call and gan call against 8 eager steps each, bit for bit,
    bf16 (packed wire) and f32; (2) `Trainer.run` on phase 8's schedule,
    call sizes, rates, waits and peak memory beside phase 8's; (3) the
    device time and busy share of one bf16 8-step gan call beside phase
    9's gan_step. Launches are counted where the kernels are captured (and
    in each graph's eager warm-up step); a replay launches them again
    without the wrappers."""
    from svcc23_fastsvc_tpu_torch.bin.common import deterministic_cudnn
    from svcc23_fastsvc_tpu_torch.config import build_train_task
    from svcc23_fastsvc_tpu_torch.data.collate import FastSVCBatcher
    from svcc23_fastsvc_tpu_torch.data.wire import WirePacker, to_device
    from svcc23_fastsvc_tpu_torch.train.graphs import StepGraphs
    from svcc23_fastsvc_tpu_torch.train.loop import Trainer, _stack

    deterministic_cudnn()
    try:
        # (1) captured against eager, bit for bit
        for dt_name, wire in (("bfloat16", "packed"), ("float32", "f32")):
            cfg = {**TRAIN_CONFIG, "compute_dtype": dt_name,
                   "wire_format": wire}
            pack = (WirePacker(hop_size=HOP) if wire == "packed"
                    else (lambda b: b))
            batcher = FastSVCBatcher(items, batch_size=TB, batch_length=16000,
                                     hop_size=HOP, seed=5)
            host = [batcher.sample_batch() for _ in range(2 * KSTEPS)]
            eager = build_train_task(cfg, device=dev, seed=7)
            graphed = build_train_task(cfg, device=dev, seed=7)
            graphs = StepGraphs(graphed)
            report = {}
            for i, phase in enumerate(("gen", "gan")):
                chunk = host[i * KSTEPS:(i + 1) * KSTEPS]
                want = [getattr(eager, f"{phase}_step")(
                    to_device(pack(b), dev)) for b in chunk]
                t0 = time.perf_counter()
                got = graphs.replay(graphs.stage(phase, pack(_stack(chunk))))
                torch.cuda.synchronize()
                report[f"{phase} capture and replay s"] = (
                    time.perf_counter() - t0)
                report[f"{phase} metrics that differ"] = sum(
                    not torch.equal(v, torch.stack([m[n] for m in want]))
                    for n, v in got.items())
                report[f"{phase} state that differs"] = _differing(eager,
                                                                   graphed)
                require(all(torch.isfinite(v).all().item()
                            for v in got.values()),
                        f"K-step {phase} {dt_name}: non-finite metrics")
            say(f"train {dt_name} ({wire} wire): a captured {KSTEPS}-step "
                f"gen call, then gan call, against {KSTEPS} eager steps "
                f"each: {report}")
            require(all(report[f"{p} metrics that differ"] == 0
                        and not any(report[f"{p} state that differs"]
                                    .values()) for p in ("gen", "gan")),
                    f"K-step calls {dt_name} differ from eager steps: {report}")
            del eager, graphed, graphs
            torch.cuda.empty_cache()

        # (2) Trainer.run with steps_per_call 8 on phase 8's schedule
        names = ", ".join(c.__name__ for c in counters)
        for c in counters:
            c.launches = 0
        want_calls = [KSTEPS, 2] * 4  # split at the log interval (10)
        workdir = tempfile.mkdtemp(prefix="chip_smoke_train_k_")
        try:
            # f32 only: phase 25 runs the recipe's bf16 at K = 8
            for dt_name, wire in (("float32", "f32"),):
                cfg = {**TRAIN_CONFIG, "compute_dtype": dt_name,
                       "wire_format": wire, "steps_per_call": KSTEPS}
                task = build_train_task(cfg, device=dev, seed=7)
                batcher = FastSVCBatcher(items, batch_size=TB,
                                         batch_length=16000, hop_size=HOP,
                                         seed=1)
                trainer = Trainer(task, batcher, config=cfg,
                                  outdir=os.path.join(workdir, dt_name))
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                trainer.run()
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated()
                rates = trainer.history
                require(all(np.isfinite(v) for x in rates
                            for v in x.values()),
                        f"K-step {dt_name}: non-finite losses {rates}")
                require(task.step == 4 * LOG_STEPS and len(rates) == 4
                        and trainer.call_sizes == want_calls
                        and len(trainer._graphs.graphs) == 4,
                        f"K-step {dt_name}: {task.step} steps, calls "
                        f"{trainer.call_sizes}, {len(rates)} logged, "
                        f"{len(trainer._graphs.graphs)} graphs")
                say(f"train K = {KSTEPS} {dt_name} ({wire} wire): calls "
                    f"{trainer.call_sizes}, mean losses to step " + "; ".join(
                        f"{x['step']}: G {x['generator_loss']:.4f}"
                        + (f" D {x['discriminator_loss']:.4f}"
                           if "discriminator_loss" in x else "")
                        for x in rates))
                for phase, timed in (("gen", 1), ("gan", 3)):
                    k = {"steps_per_s": rates[timed]["steps_per_s"],
                         "audio_s_per_s": rates[timed]["audio_s_per_s"],
                         "data_wait_s": rates[timed]["data_wait_s"],
                         "step_wait_s": rates[timed]["step_wait_s"],
                         "drain_s": rates[timed]["drain_s"],
                         "peak_mem_gib": peak / 2 ** 30}
                    one = rates_1[f"{phase} {dt_name}"]
                    say(f"train {phase} {dt_name}: K = {KSTEPS} {k}; K = 1 "
                        f"(phase 8) " + str({n: one[n] for n in (
                            "steps_per_s", "audio_s_per_s", "data_wait_s",
                            "step_wait_s", "peak_mem_gib")}))
                del task, trainer
                torch.cuda.empty_cache()
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        k_launches = {c.__name__: c.launches for c in counters}
        require(all(n > 0 for n in k_launches.values()),
                f"a kernel was not launched in the K-step run: {k_launches}")
        say(f"train K = {KSTEPS} main path: launches counted at capture "
            f"({names}) {k_launches}")

        # (3) one bf16 8-step gan call: device time and busy share
        cfg = {**TRAIN_CONFIG, "compute_dtype": "bfloat16",
               "wire_format": "packed"}
        task = build_train_task(cfg, device=dev, seed=7)
        graphs = StepGraphs(task)
        batcher = FastSVCBatcher(items, batch_size=TB, batch_length=16000,
                                 hop_size=HOP, seed=2)
        packed = WirePacker(hop_size=HOP)(_stack(
            [batcher.sample_batch() for _ in range(KSTEPS)]))

        def call():
            graphs.replay(graphs.stage("gan", packed))
        call()
        torch.cuda.synchronize()
        t_wall = time.perf_counter()
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t_wall) * 1e3 / 3
        graph = next(iter(graphs.graphs.values()))
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.graph.replay()
        end.record()
        end.synchronize()
        replay_ms = start.elapsed_time(end)
        say(f"K = {KSTEPS} gan call bf16 (B={TB} x 16000): wall "
            f"{wall_ms:.3f} ms/call ({wall_ms / KSTEPS:.3f} ms/step), "
            f"replay event time {replay_ms:.3f} ms ({replay_ms / KSTEPS:.3f} "
            f"ms/step), busy {replay_ms / wall_ms:.1%}; phase 9's gan_step: "
            f"wall "
            f"{step_profile['wall_ms']:.3f} "
            f"ms, profiler kernels {step_profile['kernels_ms']:.3f} ms, "
            f"busy {step_profile['busy']:.1%}")
        del task, graphs
    finally:
        torch.backends.cudnn.deterministic = False
    return k_launches


def vocoder_phases(dev, phases):
    """Phases 11-14: the vocoder kernels' rows, and the launches of every
    kernel in the vocoder's main path, with chaining off and on."""
    from svcc23_fastsvc_tpu_torch.bin.synthesize_b02 import (
        signal_generator,
        vocode,
    )
    from svcc23_fastsvc_tpu_torch.config import build_vocoder
    from svcc23_fastsvc_tpu_torch.dsp.f0 import dilated_factor
    from svcc23_fastsvc_tpu_torch.models.hnusfgan import PD_HALO_FS
    from svcc23_fastsvc_tpu_torch.ops.pd_block import (
        block_plan,
        chain_plan,
        frame_shifts,
        pd_adaptive_block,
        pd_adaptive_block_plain,
        pd_block_halo,
        pd_fixed_block,
        pd_fixed_block_plain,
        pd_fixed_chain,
        pd_fixed_chain_plain,
    )
    from svcc23_fastsvc_tpu_torch.ops.sine import sine_excitation

    t = time.perf_counter()
    init = torch.Generator().manual_seed(11)
    v32 = build_vocoder(VOC_CONFIG, generator=init).fold_weight_norm_()
    v32 = v32.to(dev).eval()
    v16 = copy.deepcopy(v32).to(torch.bfloat16)
    sg = signal_generator(VOC_CONFIG)
    r = np.random.default_rng(12)
    f0 = np.where(r.random((VB, VTF)) > 0.2, r.uniform(80, 400, (VB, VTF)),
                  0.0).astype(np.float32)
    df = np.stack([np.repeat(dilated_factor(f, VSR, 4), VHOP) for f in f0])
    aux = r.standard_normal((VB, VTF + 4, 62)).astype(np.float32)
    f0_d, df_d, aux_d = (torch.from_numpy(a).to(dev) for a in (
        f0[:, :, None], df.astype(np.float32), aux))

    # 11. the block kernels at the vocoder's shapes, on its own weights
    rows, cases = [], []
    T = VTF * VHOP
    blocks = {("adaptive", dil): blk for dil, blk in zip(
        v32.harmonic_network.dilations, v32.harmonic_network.conv_dilated)}
    blocks.update({("fixed", dil): blk for dil, blk in zip(
        v32.filter_network.dilations, v32.filter_network.conv_dilated)})
    gen = torch.Generator(device=dev).manual_seed(13)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((VB, T, 64), generator=gen, device=dev).to(dtype)
        c = torch.randn((VB, T, 62), generator=gen, device=dev).to(dtype)
        for kind, dil in PD_ROWS:
            params = {k: {n: v.to(dtype) for n, v in p.items()}
                      for k, p in blocks[kind, dil].block_params().items()}
            if kind == "adaptive":
                shifts = frame_shifts(df_d, dil, VHOP,
                                      pd_block_halo(dil, PD_HALO_FS, hop=VHOP))
                args, kw = (x, c, shifts, params), {"hop": VHOP}
                fn, plain = pd_adaptive_block, pd_adaptive_block_plain
                extra = shifts.numel() * 4
            else:
                args, kw = (x, c, params), {"dilation": dil}
                fn, plain = pd_fixed_block, pd_fixed_block_plain
                extra = 0
            y, ref = fn(*args, **kw), plain(*args, **kw)
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            require(torch.isfinite(y).all().item(),
                    f"pd_{kind}_block d={dil}: non-finite")
            require(err <= TOL_CONV[dtype] * scale,
                    f"pd_{kind}_block d={dil} {dtype}: max err {err} > "
                    f"{TOL_CONV[dtype]} x {scale}")
            wbytes = sum(v.numel() for p in params.values()
                         for v in p.values()) * x.element_size()
            nbytes = (x.numel() + c.numel() + y.numel()) * x.element_size() \
                + wbytes + extra
            ops = 2 * VB * T * ((3 * 64 + 62) * 128 + 64 * 64)
            b_ms, b_by = bound(nbytes, ops, dtype)
            cases.append((kind, dil, dtype))
            rows.append({
                "name": f"pd_{kind}_block {str(dtype)[6:]} ({VB},{T},64|62)"
                        f"->64 d={dil}",
                "route": "cuda",
                "source": "svcc23_fastsvc_tpu_torch/csrc/pd_block.cu",
                "replaces": "svcc23_fastsvc_tpu/ops/pallas_pd_block.py:"
                            + ("547" if kind == "adaptive" else "285"),
                "max_abs_err": err,
                "ms": cuda_ms(lambda: fn(*args, **kw)),
                "plain_ms": cuda_ms(lambda: plain(*args, **kw), iters=5,
                                    warmup=1),
                "bound_ms": b_ms,
                "bound_by": b_by,
                "library_ms": None,
                "variant": block_plan(dtype, VB, T, 64, 62, 128)["variant"],
                "device_ms": queued_ms(lambda: fn(*args, **kw)),
            })
            k = rows[-1]
            say(f"{k['name']}: max err {err:.3e} (scale {scale:.3e}); "
                f"{k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, library none, "
                f"bound {k['bound_ms']:.4f} by {k['bound_by']}); "
                f"{k['variant']}, device {k['device_ms']:.4f} ms")
        del x, c
    phases["vocoder_kernels_s"] = time.perf_counter() - t

    # 12. the vocoder's main path: 8 x 1 s, f32 then bf16
    t = time.perf_counter()
    rng = torch.Generator(device=dev)
    vocoders = ((torch.float32, v32), (torch.bfloat16, v16))

    def drive(counters, want, what):
        """One batch per dtype through `vocode`, the generator at 14 for
        each (so chain on and off draw the same excitation); each kernel's
        launches per forward must be `want`."""
        for k in counters:
            k.launches = 0
        ys, states = {}, {}
        for dtype, voc in vocoders:
            rng.manual_seed(14)
            states[dtype] = rng.get_state()
            before = [k.launches for k in counters]
            ys[dtype] = vocode(voc, sg, f0_d, aux_d, df_d, generator_rng=rng)
            torch.cuda.synchronize()
            rose = [k.launches - b for k, b in zip(counters, before)]
            require(rose == want, f"{what} {dtype} launched {rose}; want "
                                  f"{want}")
            require(tuple(ys[dtype].shape) == (VB, T, 1),
                    f"{what} output {ys[dtype].shape}")
            require(torch.isfinite(ys[dtype]).all().item(),
                    f"{what} {dtype}: not finite")
        return ys, states, {k.__name__: k.launches for k in counters}

    def vs_cpu(ys, states, what):
        """The same module on the CPU (plain versions) on utterances 0 and
        7, fed the excitation the card drew (noise from the card's
        generator)."""
        sel = list(VOC_UTTS)
        cpu_y, out = {}, {}
        for dtype, voc in vocoders:
            replay = torch.Generator(device=dev)
            replay.set_state(states[dtype])
            x = sg(f0_d.float(), replay)[sel].to(dtype).cpu()
            with torch.inference_mode():
                y_cpu, _ = copy.deepcopy(voc).cpu()(
                    x, aux_d[sel].to(dtype).cpu(), df_d[sel].cpu())
            cpu_y[dtype] = y_cpu.float()
        own = ((cpu_y[torch.bfloat16] - cpu_y[torch.float32]).abs().max()
               .item() / cpu_y[torch.float32].abs().max().item())
        for dtype in ys:
            ref = cpu_y[dtype]
            err = (ys[dtype][sel].cpu() - ref).abs().max().item()
            scale = ref.abs().max().item()
            limit = (TOL_DECODE[torch.float32] if dtype == torch.float32
                     else BF16_FACTOR * own)
            out[str(dtype)[6:]] = {"max_abs_err": err, "max_abs_y": scale,
                                   "err / max |y|": err / scale,
                                   "limit": limit}
            require(err <= limit * scale, f"{what} {dtype} vs CPU: max err "
                                          f"{err} > {limit} x {scale}")
        say(f"{what} vs the same module on the CPU (utterances {sel}): "
            f"{out}; CPU bf16 vs CPU f32: {own:.4e} of max |y|")

    def rates_of(what):
        """Whole batches by CUDA events, then the busy share."""
        out = {}
        for dtype, voc in vocoders:
            def batch(voc=voc):
                vocode(voc, sg, f0_d, aux_d, df_d, generator_rng=rng)
            ms = cuda_ms(batch, iters=5, warmup=2)
            t_wall = time.perf_counter()
            for _ in range(3):
                batch()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t_wall) * 1e3 / 3
            per_kernel = device_ms(batch)
            busy = sum(per_kernel.values())
            out[str(dtype)[6:]] = {"batch_ms": ms,
                                   "audio_s_per_s": VB * T / VSR / ms * 1e3,
                                   "wall_ms": wall_ms, "kernels_ms": busy,
                                   "busy": busy / wall_ms}
            say(f"profile {what} {str(dtype)[6:]}: wall {wall_ms:.3f} "
                f"ms/batch, kernels {busy:.3f} ms, busy {busy / wall_ms:.1%}")
            for kname, kms in list(per_kernel.items())[:10]:
                say(f"  {kms:8.4f} ms {kms / busy:6.1%}  {kname[:110]}")
        say(f"{what} {VB} x {T / VSR:.0f} s: {out}")
        return out

    ys, states, launches = drive(
        (pd_adaptive_block, pd_fixed_block, sine_excitation), [20, 35, 1],
        "vocoder")
    say(f"vocoder main path: launches {launches}")
    vs_cpu(ys, states, "vocoder")
    phases["vocoder_s"] = time.perf_counter() - t
    t = time.perf_counter()
    rates = rates_of("vocoder")
    phases["vocoder_timings_s"] = time.perf_counter() - t
    for row, (kind, dil, dtype) in zip(rows, cases):
        row["launches"] = launches[f"pd_{kind}_block"]

    # 13. the chain kernel at the vocoder's shapes, on its own weights: the
    # noise net's five d=1 blocks and a filter cycle's (1, 2, 4, 8, 16)
    t = time.perf_counter()
    chain_cases = []
    gen = torch.Generator(device=dev).manual_seed(15)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((VB, T, 64), generator=gen, device=dev).to(dtype)
        c = torch.randn((VB, T, 62), generator=gen, device=dev).to(dtype)
        for net in (v32.noise_network, v32.filter_network):
            dils = net.dilations[:5]
            params = [{k: {n: v.to(dtype) for n, v in p.items()}
                       for k, p in blk.block_params().items()}
                      for blk in net.conv_dilated[:5]]
            kw = {"dilations": dils}

            def blocks(x=x, c=c, params=params, dils=dils):
                for p, d in zip(params, dils):
                    x = pd_fixed_block(x, c, p, dilation=d)
                return x
            y = pd_fixed_chain(x, c, params, **kw)
            ref = pd_fixed_chain_plain(x, c, params, **kw)
            same = torch.equal(y, blocks())
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            require(torch.isfinite(y).all().item(),
                    f"pd_fixed_chain d={dils}: non-finite")
            require(err <= TOL_CONV[dtype] * scale,
                    f"pd_fixed_chain d={dils} {dtype}: max err {err} > "
                    f"{TOL_CONV[dtype]} x {scale}")
            wbytes = sum(v.numel() for p in params for q in p.values()
                         for v in q.values()) * x.element_size()
            nbytes = (x.numel() + c.numel() + y.numel()) * x.element_size() \
                + wbytes
            ops = len(dils) * 2 * VB * T * ((3 * 64 + 62) * 128 + 64 * 64)
            b_ms, b_by = bound(nbytes, ops, dtype)
            chain_cases.append({
                "name": f"pd_fixed_chain {str(dtype)[6:]} ({VB},{T},64|62)"
                        f"->64 d={','.join(map(str, dils))}",
                "route": "cuda",
                "source": "svcc23_fastsvc_tpu_torch/csrc/pd_chain.cu",
                "replaces": "svcc23_fastsvc_tpu/ops/pallas_pd_block.py:473",
                "max_abs_err": err,
                "ms": cuda_ms(lambda: pd_fixed_chain(x, c, params, **kw)),
                "plain_ms": cuda_ms(lambda: pd_fixed_chain_plain(
                    x, c, params, **kw), iters=3, warmup=1),
                "bound_ms": b_ms,
                "bound_by": b_by,
                "library_ms": None,
                "replaced_ms": cuda_ms(blocks),
                "variant": block_plan(dtype, VB, T, 64, 62, 128)["variant"],
                "equals_the_block_kernels": same,
            })
            k = chain_cases[-1]
            plan = chain_plan(dtype, VB, T, 64, 62, 128, tuple(dils))
            k.update(grid={n: plan[n] for n in (
                         "n_blocks", "seg_rows", "tile_rows", "region_rows")},
                     device_ms=queued_ms(
                         lambda: pd_fixed_chain(x, c, params, **kw)),
                     replaced_device_ms=queued_ms(blocks))
            say(f"{k['name']}: max err {err:.3e} (scale {scale:.3e}); "
                f"{k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, the {len(dils)}"
                f" block launches it replaces {k['replaced_ms']:.4f}, library "
                f"none, bound {k['bound_ms']:.4f} by {k['bound_by']}); equal "
                f"to the block kernels bit for bit: {same}; {k['variant']}, "
                f"grid {k['grid']}, device {k['device_ms']:.4f} ms, the block "
                f"launches' device {k['replaced_device_ms']:.4f} ms")
        del x, c

    # 13, the wide walk: at widths the mma and ffma walks do not hold
    # (3R + A = 288; G = 160), a fixed block and a chain of five at the
    # vocoder's shape against their plain versions, the chain against the
    # blocks bit for bit (the JAX vocoder takes every width)
    def wide_params(R, A, G, dtype):
        def w(*shape):
            return (torch.randn(shape, generator=gen, device=dev)
                    / (shape[0] * shape[1]) ** 0.5).to(dtype)
        return {"conv": {"w": w(3, R, G), "b": w(1, G)[0]},
                "aux": {"w": w(1, A, G)}, "out": {"w": w(1, G // 2, R),
                                                  "b": w(1, R)[0]}}
    dils = (1, 2, 4, 8, 16)
    for R, A, G in ((64, 96, 128), (64, 62, 160)):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((VB, T, R), generator=gen, device=dev).to(dtype)
            c = torch.randn((VB, T, A), generator=gen, device=dev).to(dtype)
            params = [wide_params(R, A, G, dtype) for _ in dils]
            require(block_plan(dtype, VB, T, R, A, G)["variant"] == "wide"
                    and chain_plan(dtype, VB, T, R, A, G, dils)["variant"]
                    == "wide", f"R {R} A {A} G {G}: not the wide walk")

            def blocks(x=x, c=c, params=params):
                for p, d in zip(params, dils):
                    x = pd_fixed_block(x, c, p, dilation=d)
                return x
            errs = {}
            for what, fn, plain in (
                    ("block", lambda: pd_fixed_block(x, c, params[0],
                                                     dilation=1),
                     lambda: pd_fixed_block_plain(x, c, params[0],
                                                  dilation=1)),
                    ("chain", lambda: pd_fixed_chain(x, c, params,
                                                     dilations=dils),
                     lambda: pd_fixed_chain_plain(x, c, params,
                                                  dilations=dils))):
                y, ref = fn(), plain()
                torch.cuda.synchronize()
                err = (y.float() - ref.float()).abs().max().item()
                scale = ref.float().abs().max().item()
                require(torch.isfinite(y).all().item()
                        and err <= TOL_CONV[dtype] * scale,
                        f"wide {what} R {R} A {A} G {G} {dtype}: max err "
                        f"{err} > {TOL_CONV[dtype]} x {scale}")
                nbytes = (x.numel() + c.numel() + y.numel()) \
                    * x.element_size()
                ops = 2 * VB * T * ((3 * R + A) * G + G // 2 * R)
                if what == "chain":
                    same = torch.equal(y, blocks())
                    require(same, f"wide chain R {R} A {A} G {G} {dtype}: "
                                  "not the blocks' bits")
                    ops *= len(dils)
                b_ms, b_by = bound(nbytes, ops, dtype)
                errs[what] = {"max_abs_err": err, "scale": scale,
                              "device_ms": queued_ms(fn),
                              "plain_ms": cuda_ms(plain, iters=3, warmup=1),
                              "bound_ms": b_ms, "bound_by": b_by}
                del y, ref
            errs["chain"]["blocks_device_ms"] = queued_ms(blocks)
            errs["chain"]["equals_the_block_kernels"] = same
            say(f"wide walk ({VB},{T},{R}|{A}) G {G} {dtype}: {errs}")
            del x, c
    phases["chain_kernels_s"] = time.perf_counter() - t

    # 14. the vocoder's main path with FASTSVC_PD_CHAIN=5: the noise net and
    # each filter cycle's (1, 2, 4, 8, 16) prefix as chains
    t = time.perf_counter()
    saved = os.environ.get("FASTSVC_PD_CHAIN")
    os.environ["FASTSVC_PD_CHAIN"] = "5"
    try:
        ys_c, states_c, chain_launches = drive(
            (pd_adaptive_block, pd_fixed_chain, pd_fixed_block,
             sine_excitation), [20, 4, 15, 1],
            "vocoder with chains")
        say(f"vocoder with chains, main path: launches {chain_launches}")
        vs_off = {}
        for dtype, y in ys_c.items():
            err = (y - ys[dtype]).abs().max().item()
            scale = ys[dtype].abs().max().item()
            vs_off[str(dtype)[6:]] = {"max_abs_diff": err,
                                      "diff / max |y|": err / scale,
                                      "bit_identical": torch.equal(
                                          y, ys[dtype])}
            if dtype == torch.float32:
                require(err <= 1e-5 * scale, f"vocoder with chains f32 vs "
                                             f"chains off: {err} > 1e-5 x "
                                             f"{scale}")
        say(f"vocoder with chains vs chains off, on the card: {vs_off}")
        vs_cpu(ys_c, states_c, "vocoder with chains")
        chain_rates = rates_of("vocoder with chains")
    finally:
        if saved is None:
            del os.environ["FASTSVC_PD_CHAIN"]
        else:
            os.environ["FASTSVC_PD_CHAIN"] = saved
    say("vocoder batch ms, chains off -> on: " + ", ".join(
        f"{dt} {rates[dt]['batch_ms']:.3f} -> "
        f"{chain_rates[dt]['batch_ms']:.3f} (device "
        f"{rates[dt]['kernels_ms']:.3f} -> "
        f"{chain_rates[dt]['kernels_ms']:.3f})" for dt in rates))
    phases["vocoder_chain_s"] = time.perf_counter() - t
    for row in chain_cases:
        row["launches"] = chain_launches["pd_fixed_chain"]
    launches = {**launches, "pd_fixed_chain": 0}
    return rows + chain_cases, {"vocoder": launches,
                                "vocoder_chain": chain_launches}


# (what it is, batch, T after the block's downsample, block index) of the
# down chain: the decode batch's four blocks (each in the sine and the
# loudness chain) and the JAX A/B tool's two (tools/down_chain_ab.py)
DOWN_SHAPES = [
    ("decode block 0 (1->24)", B, 64000, 0),
    ("decode block 1 (24->48)", B, 12800, 1),
    ("decode block 2 (48->96)", B, 3200, 2),
    ("decode block 3 (96->192)", B, 800, 3),
    ("tool block 0 (1->24)", 32, 24000, 0),
    ("tool block 1 (24->48)", 32, 12000, 1),
]


def down_chain_phases(dev, phases, gens, sg, inputs, rng_states, ys_off,
                      rate_off):
    """Phases 15 and 16: the down-chain kernel against its plain version and
    against the launches it replaces, then decode with the down-chain mode
    on (its launches, all 8 utterances against the CPU, batch times beside
    phase 5's)."""
    from svcc23_fastsvc_tpu_torch.bin.decode_fastsvc import synthesize
    from svcc23_fastsvc_tpu_torch.ops.down_chain import (
        down_chain_fwd,
        down_chain_fwd_plain,
        down_plan,
        pack_weights,
        set_down_chain_mode,
    )
    from svcc23_fastsvc_tpu_torch.ops.sine import sine_excitation
    from svcc23_fastsvc_tpu_torch.ops.window_conv import window_conv

    # 15. the kernel at the decode and tool shapes, on the generator's
    # weights (its sine chain)
    t = time.perf_counter()
    rows = []
    gen = torch.Generator(device=dev).manual_seed(16)
    for dtype, g in gens.items():
        for what, nb, T, i in DOWN_SHAPES:
            blk = g.downsampling_sine[i]
            params = blk.block_params()
            cin, cout = blk.in_channels, blk.mid_channels
            x = torch.randn((nb, T, cin), generator=gen, device=dev).to(dtype)
            with torch.inference_mode():
                y = down_chain_fwd(x, params)
                ref = down_chain_fwd_plain(x, params)
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            require(torch.isfinite(y).all().item(),
                    f"down_chain_fwd {what}: non-finite")
            require(err <= TOL_CONV[dtype] * scale,
                    f"down_chain_fwd {what} {dtype}: max err {err} > "
                    f"{TOL_CONV[dtype]} x {scale}")
            wbytes = sum(p[k].numel() for p in params.values()
                         for k in ("w", "b")) * x.element_size()
            nbytes = (x.numel() + y.numel()) * x.element_size() + wbytes
            ops = 2 * nb * T * (3 * cin * cout + 6 * cout * cout + cin * cout)
            b_ms, b_by = bound(nbytes, ops, dtype)

            def timed(fn, **kw):
                with torch.inference_mode():
                    return cuda_ms(fn, **kw)

            def device(fn):
                with torch.inference_mode():
                    return queued_ms(fn)
            rows.append({
                "name": f"down_chain_fwd {str(dtype)[6:]} {what} "
                        f"({nb},{T},{cin})->{cout} d=1,2,4",
                "route": "cuda",
                "source": "svcc23_fastsvc_tpu_torch/csrc/down_chain.cu",
                "replaces": "svcc23_fastsvc_tpu/ops/pallas_down_chain.py:158",
                "max_abs_err": err,
                "ms": timed(lambda: down_chain_fwd(x, params)),
                "plain_ms": timed(lambda: down_chain_fwd_plain(x, params),
                                  iters=5, warmup=1),
                "bound_ms": b_ms,
                "bound_by": b_by,
                "library_ms": None,
                "replaced_ms": timed(lambda: blk.unfused(x)),
            })
            k = rows[-1]
            plan = down_plan(dtype, nb, T, cin, cout)
            k.update(variant=plan["variant"], rows=plan["tile_rows"],
                     n_blocks=plan["n_blocks"],
                     device_ms=device(lambda: down_chain_fwd(x, params)),
                     replaced_device_ms=device(lambda: blk.unfused(x)))
            say(f"{k['name']}: max err {err:.3e} (scale {scale:.3e}); "
                f"{k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, the 3 window "
                f"convs + residual it replaces {k['replaced_ms']:.4f}, "
                f"library none, bound {k['bound_ms']:.4f} by {k['bound_by']})"
                f"; {k['variant']} ({k['rows']} rows, {k['n_blocks']} "
                f"blocks), device {k['device_ms']:.4f} ms, the replaced "
                f"launches' device {k['replaced_device_ms']:.4f} ms")
            del x, y, ref
    phases["down_chain_kernels_s"] = time.perf_counter() - t

    # 16. decode with the down-chain mode on, f32 then bf16
    t = time.perf_counter()
    ppg, f0_in, lft, emb = inputs
    rng = torch.Generator(device=dev)
    counters = (window_conv, down_chain_fwd, sine_excitation)
    for k in counters + (pack_weights,):
        k.launches = 0
    set_down_chain_mode("1")
    try:
        ys = {}
        for dtype, g in gens.items():
            rng.set_state(rng_states[dtype])
            before = [k.launches for k in counters]
            ys[dtype] = synthesize(g, sg, ppg, f0_in, lft, emb,
                                   generator_rng=rng)
            torch.cuda.synchronize()
            rose = [k.launches - b for k, b in zip(counters, before)]
            require(rose == [36, 8, 1],
                    f"decode with the down chain {dtype} launched {rose} "
                    "(window_conv, down_chain_fwd, sine); want [36, 8, 1]")
            require(tuple(ys[dtype].shape) == tuple(ys_off[dtype].shape)
                    and torch.isfinite(ys[dtype]).all().item(),
                    f"decode with the down chain {dtype}: output")
        launches = {k.__name__: k.launches for k in counters + (pack_weights,)}
        # the weights are packed once each (here the loudness chain's four
        # blocks a dtype; phase 15 packed the sine chain's) and reused after
        require(launches["pack_weights"] <= 16,
                f"decode with the down chain packed {launches['pack_weights']}"
                " times; want at most once per block and dtype")
        say(f"decode with the down chain, main path: launches {launches} "
            "(pack_weights: the first use of each block's weights)")
        vs_off = {}
        for dtype, y in ys.items():
            err = (y - ys_off[dtype]).abs().max().item()
            vs_off[str(dtype)[6:]] = {
                "max_abs_diff": err,
                "diff / max |y|": err / ys_off[dtype].abs().max().item(),
                "bit_identical": torch.equal(y, ys_off[dtype])}
        say(f"decode with the down chain vs without, on the card: {vs_off}")
        err = decode_vs_cpu(dev, gens, sg, inputs, rng_states, ys)
        say(f"decode with the down chain vs the same module on the CPU: "
            f"{err}")
        audio_s = B * TF * HOP / SR
        rate = {}
        packs = pack_weights.launches
        for dtype, g in gens.items():
            def batch(g=g):
                synthesize(g, sg, ppg, f0_in, lft, emb, generator_rng=rng)
            ms = cuda_ms(batch, iters=5, warmup=2)
            per_kernel = device_ms(batch)
            rate[str(dtype)[6:]] = {"batch_ms": ms,
                                    "audio_s_per_s": audio_s / ms * 1e3,
                                    "kernels_ms": sum(per_kernel.values())}
            for kname, kms in list(per_kernel.items())[:8]:
                say(f"  {kms:8.4f} ms  {kname[:110]}")
        require(pack_weights.launches == packs,
                "the timed decodes packed the weights again")
        say("timed decodes with the down chain: no weight pack launched")
    finally:
        set_down_chain_mode("0")
    say(f"decode {B} x {TF * HOP / SR:.0f} s with the down chain: {rate}; "
        f"without (phase 5): {rate_off}")
    phases["decode_chain_s"] = time.perf_counter() - t
    for row in rows:
        row["launches"] = launches["down_chain_fwd"]
        row["pack_launches"] = launches["pack_weights"]
    return rows, launches


# (what it is, B, T, Cin, Cout, dilation, input leaky) of the fused conv's
# shapes: the generator's training convs at the recipe's batch (T >= 256),
# two of decode's (8 x 400 frames) and Tacotron2's bap conv1 (4 x 400)
FUSED_SHAPES = [
    ("train down block conv1", TB, 16000, 1, 24, 1, 0.2),
    ("train last up block conv3", TB, 16000, 24, 24, 27, 0.2),
    ("train up block 3 conv2", TB, 3200, 48, 48, 9, 0.2),
    ("train up block 2 conv1", TB, 800, 96, 96, 3, 0.2),
    ("decode down block conv1", B, 64000, 1, 24, 1, 0.2),
    ("decode up block 1 conv_first", B, 400, 144, 192, 1, None),
    ("tacotron2 bap conv1", 4, 400, 86, 43, 2, None),
]
# B02 Tacotron2 at the width egs/svcc23/baseline02/conf/taco2.yaml and the
# JAX package's bin/train_b02.py give it (hidden 1024, econv 512, prenet
# 256 at the model's defaults); 4 utterances padded to 400 frames
TACO_CONFIG = {"generator_params": {
    "input_dim": 256, "output_dim": 60, "dec_layers": 2,
    "multi_speaker": True, "spk_emb_dim": 512, "integrate_logf0": True}}
TB2, TF2 = 4, 400
TACO_LENGTHS = (400, 371, 310, 256)


def fused_conv_phases(dev, phases, items, gens, sg, inputs, rng_states,
                      ys_off, rate_off, train_rates_off):
    """Phases 17-20: the fused-conv kernels (#5, #6) against their plain
    versions, the library and the window-conv launches they displace; then
    FastSVC training and decode with FASTSVC_PALLAS_CONV=1, and the B02
    acoustic model's decode with the switch off and on, chained into the
    vocoder."""
    from svcc23_fastsvc_tpu_torch.bin.common import deterministic_cudnn
    from svcc23_fastsvc_tpu_torch.bin.decode_fastsvc import synthesize
    from svcc23_fastsvc_tpu_torch.config import build_train_task
    from svcc23_fastsvc_tpu_torch.data.collate import FastSVCBatcher
    from svcc23_fastsvc_tpu_torch.data.wire import to_device
    from svcc23_fastsvc_tpu_torch.ops.conv import (
        decide_conv_lowering,
        set_pallas_conv_mode,
    )
    from svcc23_fastsvc_tpu_torch.ops.fused_conv import (
        bwd_plan,
        fused_conv1d,
        fused_conv1d_bwd,
        fused_conv1d_bwd_plain,
        fused_conv1d_plain,
    )
    from svcc23_fastsvc_tpu_torch.ops.sine import sine_excitation
    from svcc23_fastsvc_tpu_torch.ops.window_conv import (
        fwd_plan,
        window_conv,
        window_conv_dx,
        window_conv_wgrad,
    )

    F = torch.nn.functional

    # 17. the kernels on their own, f32 and bf16
    t = time.perf_counter()
    rows = []
    gen = torch.Generator(device=dev).manual_seed(17)
    for dtype in (torch.float32, torch.bfloat16):
        for what, nb, T, cin, cout, dil, slope in FUSED_SHAPES:
            x = torch.randn((nb, T, cin), generator=gen, device=dev).to(dtype)
            g = torch.randn((nb, T, cout), generator=gen, device=dev).to(dtype)
            w = (torch.randn((3, cin, cout), generator=gen, device=dev)
                 / (3 * cin) ** 0.5).to(dtype)
            b = (torch.randn((cout,), generator=gen, device=dev) * 0.1).to(
                dtype)
            got = (fused_conv1d(x, w, b, dil, dil, dil, slope),
                   *fused_conv1d_bwd(x, g, w, dil, dil, dil, slope))
            want = (fused_conv1d_plain(x, w, b, dil, dil, dil, slope),
                    *fused_conv1d_bwd_plain(x, g, w, dil, dil, dil, slope))
            torch.cuda.synchronize()
            errs = {}
            for part, a, c in zip(("y", "dx", "dw", "db"), got, want):
                err = (a.float() - c.float()).abs().max().item()
                scale = c.float().abs().max().item()
                require(torch.isfinite(a).all().item(),
                        f"fused conv {part} {what}: non-finite")
                require(err <= TOL_CONV[dtype] * scale,
                        f"fused conv {part} {what} {dtype}: max err {err} > "
                        f"{TOL_CONV[dtype]} x {scale}")
                errs[part] = err
            again = fused_conv1d_bwd(x, g, w, dil, dil, dil, slope)
            require(all(torch.equal(a, c) for a, c in zip(got[1:], again)),
                    f"fused conv backward {what} {dtype}: two calls differ")
            # the library's layouts: channels first, activation applied
            xa = F.leaky_relu(x, slope) if slope is not None else x
            xt, gt = (v.transpose(1, 2).contiguous() for v in (xa, g))
            wt = w.permute(2, 1, 0).contiguous()
            esize = x.element_size()
            ops = 2 * nb * T * 3 * cin * cout
            shape = f"({nb},{T},{cin})->{cout} d={dil}"
            dt = str(dtype)[6:]
            fwd_bytes = (x.numel() + w.numel() + b.numel()
                         + nb * T * cout) * esize
            bwd_bytes = ((2 * x.numel() + g.numel() + w.numel()) * esize
                         + (w.numel() + cout) * 4)
            for name, nbytes, n_ops, err, fn, plain, lib, repl, line in (
                ("fused_conv1d", fwd_bytes, ops, errs["y"],
                 lambda: fused_conv1d(x, w, b, dil, dil, dil, slope),
                 lambda: fused_conv1d_plain(x, w, b, dil, dil, dil, slope),
                 lambda: F.conv1d(xt, wt, b, padding=dil, dilation=dil),
                 lambda: window_conv(x, w, b, dil, slope), 205),
                ("fused_conv1d_bwd", bwd_bytes, 2 * ops,
                 max(errs["dx"], errs["dw"], errs["db"]),
                 lambda: fused_conv1d_bwd(x, g, w, dil, dil, dil, slope),
                 lambda: fused_conv1d_bwd_plain(x, g, w, dil, dil, dil,
                                                slope),
                 # dx, dw and db in one library call
                 lambda: torch.ops.aten.convolution_backward(
                     gt, xt, wt, [cout], [1], [dil], [dil], False, [0], 1,
                     [True, True, True]),
                 lambda: (window_conv_dx(g, w, dil, x, slope),
                          window_conv_wgrad(x, g, 3, dil, slope)), 240),
            ):
                b_ms, b_by = bound(nbytes, n_ops, dtype)
                rows.append({
                    "name": f"{name} {dt} {what} {shape}",
                    "route": "cuda",
                    "source": "svcc23_fastsvc_tpu_torch/csrc/fused_conv.cu",
                    "replaces": f"svcc23_fastsvc_tpu/ops/pallas_conv.py:{line}",
                    "max_abs_err": err,
                    "ms": cuda_ms(fn),
                    "plain_ms": cuda_ms(plain, iters=5, warmup=1),
                    "bound_ms": b_ms,
                    "bound_by": b_by,
                    "library_ms": cuda_ms(lib),
                    "library": ("F.conv1d" if name == "fused_conv1d" else
                                "torch.ops.aten.convolution_backward, one "
                                "call"),
                    "replaced_ms": cuda_ms(repl),
                    "replaced": ("window_conv" if name == "fused_conv1d"
                                 else "window_conv_dx + window_conv_wgrad"),
                })
                k = rows[-1]
                plan = (fwd_plan(dtype, nb, T, cin, cout)  # #2's template
                        if name == "fused_conv1d"
                        else bwd_plan(dtype, nb, T, 3, cin, cout))
                k.update(variant=plan["variant"],
                         rows=plan.get("rows", plan.get("tm")),
                         device_ms=queued_ms(fn),
                         library_device_ms=queued_ms(lib),
                         replaced_device_ms=queued_ms(repl))
                say(f"{k['name']}: max err {err:.3e}; {k['ms']:.4f} ms (plain "
                    f"{k['plain_ms']:.4f}, library {k['library_ms']:.4f}, "
                    f"the window-conv launches it displaces "
                    f"{k['replaced_ms']:.4f}, bound {k['bound_ms']:.4f} by "
                    f"{k['bound_by']}); {k['variant']} ({k['rows']} rows), "
                    f"device {k['device_ms']:.4f} ms, library device "
                    f"{k['library_device_ms']:.4f} ms, displaced device "
                    f"{k['replaced_device_ms']:.4f} ms")
            del x, g, w, b, got, want, again, xt, gt
    phases["fused_kernels_s"] = time.perf_counter() - t

    # 18. FastSVC training with the switch on, cuDNN deterministic as in
    # phases 7-9
    t = time.perf_counter()
    counters = (fused_conv1d, fused_conv1d_bwd, window_conv, window_conv_dx,
                window_conv_wgrad, sine_excitation)
    deterministic_cudnn()
    try:
        # "auto" runs the probe (#5, #6 against their plain versions, f32
        # and bf16) on the card; "1" then takes the kernel without it
        set_pallas_conv_mode("auto")
        require(decide_conv_lowering(dev) == "fused+window",
                "the auto probe did not pass")
        set_pallas_conv_mode("1")
        # the gan_step only (phase 7 holds the gen_step too): its G update
        # runs the gen_step's convs, and the CPU f64 reference of a second
        # step is the costliest check of the script
        train_vs_cpu(dev, items, "with the fused conv: ", steps=("gan",))
        train_rates, train_launches = trainer_run(
            dev, items, counters, "with the fused conv: ")
        # device time of one bf16 gan_step, beside phase 9's
        cfg = {**TRAIN_CONFIG, "compute_dtype": "bfloat16"}
        task = build_train_task(cfg, device=dev, seed=7)
        tbatch = to_device(FastSVCBatcher(items, batch_size=TB,
                                          batch_length=16000, hop_size=HOP,
                                          seed=2).sample_batch(), dev)
        task.gan_step(tbatch)
        per_kernel = device_ms(lambda: task.gan_step(tbatch), n=1)
        say(f"profile gan_step bf16 with the fused conv: kernels "
            f"{sum(per_kernel.values()):.3f} ms")
        for kname, ms in list(per_kernel.items())[:12]:
            say(f"  {ms:8.4f} ms  {kname[:110]}")
        del task
    finally:
        set_pallas_conv_mode("0")
        torch.backends.cudnn.deterministic = False
    for k, v in train_rates.items():
        off = train_rates_off[k]
        say(f"train {k} steps/s, switch off (phase 8) -> on: "
            f"{off['steps_per_s']:.3f} -> {v['steps_per_s']:.3f}")
    phases["train_fused_s"] = time.perf_counter() - t

    # 19. decode with the switch on, f32 then bf16
    t = time.perf_counter()
    ppg, f0_in, lft, emb = inputs
    rng = torch.Generator(device=dev)
    counters = (fused_conv1d, window_conv, sine_excitation)
    for k in counters:
        k.launches = 0
    set_pallas_conv_mode("1")
    try:
        ys, per_fwd = {}, []
        for dtype, g in gens.items():
            rng.set_state(rng_states[dtype])
            before = [k.launches for k in counters]
            ys[dtype] = synthesize(g, sg, ppg, f0_in, lft, emb,
                                   generator_rng=rng)
            torch.cuda.synchronize()
            per_fwd.append([k.launches - b for k, b in zip(counters, before)])
            require(tuple(ys[dtype].shape) == tuple(ys_off[dtype].shape)
                    and torch.isfinite(ys[dtype]).all().item(),
                    f"decode with the fused conv {dtype}: output")
        decode_launches = {k.__name__: k.launches for k in counters}
        # every conv of phase 4's 60 but the 384-channel fused FiLM conv
        require(per_fwd == [[59, 1, 1]] * 2,
                f"decode with the fused conv launched {per_fwd} (fused, "
                "window, sine) per forward; want [59, 1, 1]")
        say(f"decode with the fused conv, main path: launches "
            f"{decode_launches}, per forward {per_fwd[0]}")
        err = decode_vs_cpu(dev, gens, sg, inputs, rng_states, ys)
        say(f"decode with the fused conv vs the same module on the CPU: "
            f"{err}")
        audio_s = B * TF * HOP / SR
        rate = {}
        for dtype, g in gens.items():
            def batch(g=g):
                synthesize(g, sg, ppg, f0_in, lft, emb, generator_rng=rng)
            ms = cuda_ms(batch, iters=5, warmup=2)
            rate[str(dtype)[6:]] = {"batch_ms": ms,
                                    "audio_s_per_s": audio_s / ms * 1e3}
    finally:
        set_pallas_conv_mode("0")
    say(f"decode {B} x {TF * HOP / SR:.0f} s with the fused conv: {rate}; "
        f"without (phase 5): {rate_off}")
    phases["decode_fused_s"] = time.perf_counter() - t

    # 20. B02 decode: Tacotron2 then the vocoder
    t = time.perf_counter()
    b02_launches, b02 = b02_phase(dev)
    phases["b02_decode_s"] = time.perf_counter() - t

    paths = {"train_fused": train_launches, "decode_fused": decode_launches,
             "b02_decode_fused": b02_launches}
    for row in rows:
        name = row["name"].split(" ")[0]
        row["launches"] = sum(p.get(name, 0) for p in paths.values())
    return rows, paths


def b02_phase(dev):
    """Phase 20: the B02 Tacotron2 at full width (random weights from a seed)
    decodes 4 utterances padded to 400 frames, f32 and bf16, with the switch
    off and on, against the CPU on the same prenet masks; then the decoded
    mcep | bap and the shifted F0 go through the vocoder (`vocode`)."""
    from svcc23_fastsvc_tpu_torch.bin.decode_b02 import decode_batch
    from svcc23_fastsvc_tpu_torch.bin.synthesize_b02 import (
        signal_generator,
        vocode,
    )
    from svcc23_fastsvc_tpu_torch.config import (
        build_acoustic_model,
        build_vocoder,
    )
    from svcc23_fastsvc_tpu_torch.dsp.f0 import dilated_factor
    from svcc23_fastsvc_tpu_torch.ops.conv import set_pallas_conv_mode
    from svcc23_fastsvc_tpu_torch.ops.fused_conv import fused_conv1d

    init = torch.Generator().manual_seed(20)
    t32 = build_acoustic_model(TACO_CONFIG, generator=init).eval()
    r = np.random.default_rng(21)
    shift = 2.0 ** (4 / 12)  # a 4-semitone conversion
    f0 = np.where(r.random((TB2, TF2)) > 0.2, r.uniform(80, 300, (TB2, TF2)),
                  0.0) * shift
    lf0 = np.log(np.maximum(f0, 80.0))  # continuous log-F0
    cpu_in = [torch.from_numpy(a.astype(np.float32)) for a in (
        r.standard_normal((TB2, TF2, 256)), 0.1 * r.standard_normal(
            (TB2, TF2, 1)), lf0[:, :, None], r.standard_normal((TB2, 512)))]
    lengths = torch.tensor(TACO_LENGTHS)
    masks = t32.prenet_masks(TF2, TB2, generator=torch.Generator()
                             .manual_seed(22))

    def run(model, device, args):
        ppg, lft, lf0_, emb = (a.to(device) for a in args)
        return decode_batch(model, ppg, lengths.to(device), lft, lf0_, emb,
                            prenet_masks=masks.to(device))

    cpu = {torch.float32: run(t32, "cpu", cpu_in)}
    cpu[torch.bfloat16] = run(copy.deepcopy(t32).to(torch.bfloat16), "cpu",
                              cpu_in)
    scale = cpu[torch.float32].abs().max().item()
    own = (cpu[torch.bfloat16] - cpu[torch.float32]).abs().max().item()
    models = {torch.float32: copy.deepcopy(t32).to(dev)}
    models[torch.bfloat16] = copy.deepcopy(models[torch.float32]).to(
        torch.bfloat16)
    out, launches, ys = {}, {}, {}
    cpu64 = None
    for mode in ("0", "1"):
        set_pallas_conv_mode(mode)
        try:
            for dtype, model in models.items():
                fused_conv1d.launches = 0
                y = run(model, dev, cpu_in)
                torch.cuda.synchronize()
                n = fused_conv1d.launches
                require(tuple(y.shape) == (TB2, TF2, 63)
                        and torch.isfinite(y).all().item(),
                        f"B02 decode {dtype} switch {mode}: output")
                require(n == (8 if mode == "1" else 0),
                        f"B02 decode {dtype} switch {mode}: {n} fused-conv "
                        "launches; want 8 (bap conv1, conv3, 6 FiLM convs) "
                        "with the switch, 0 without")
                launches[f"{mode} {dtype}"] = n
                err = (y.cpu() - cpu[dtype]).abs().max().item()
                key = f"switch {mode} {str(dtype)[6:]}"
                if dtype == torch.bfloat16:
                    held = f"CPU bf16, limit {BF16_FACTOR} x {own / scale:.3e}"
                    ok = err <= BF16_FACTOR * own
                elif err <= TOL_DECODE[torch.float32] * scale:
                    held, ok = "CPU f32, limit 1e-3", True
                else:
                    if cpu64 is None:
                        cpu64 = run(copy.deepcopy(t32).double(), "cpu",
                                    [a.double() for a in cpu_in])
                    e64 = (y.cpu().double() - cpu64).abs().max().item()
                    e32 = (cpu[torch.float32].double() - cpu64).abs().max(
                        ).item()
                    held = f"CPU f64, limit {F32_FACTOR} x {e32 / scale:.3e}"
                    ok, err = e64 <= F32_FACTOR * e32, e64
                out[key] = {"err / max |y|": err / scale, "held to": held}
                require(ok, f"B02 decode {key}: {err / scale} of max |y| "
                            f"({held})")
                ys[mode, dtype] = y
                ms = cuda_ms(lambda model=model: run(model, dev, cpu_in),
                             iters=3, warmup=1)
                out[key].update(batch_ms=ms,
                                frames_per_s=TB2 * TF2 / ms * 1e3)
        finally:
            set_pallas_conv_mode("0")
    say(f"B02 decode ({TB2} x {TF2} frames) vs the CPU on the same prenet "
        f"masks: {out}; CPU bf16 vs CPU f32 {own / scale:.3e} of max |y|")
    for dtype, model in models.items():
        def batch(model=model):
            run(model, dev, cpu_in)
        t_wall = time.perf_counter()
        batch()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t_wall) * 1e3
        per_kernel = device_ms(batch, n=1, host_ops=False)
        busy = sum(per_kernel.values())
        say(f"profile B02 decode {str(dtype)[6:]}: wall {wall_ms:.3f} ms/batch, "
            f"kernels {busy:.3f} ms, busy {busy / wall_ms:.1%}")
        for kname, kms in list(per_kernel.items())[:8]:
            say(f"  {kms:8.4f} ms {kms / busy:6.1%}  {kname[:110]}")

    # the vocoder of phases 11-14 at aux 63 (mcep | bap), 24 kHz, hop 160
    voc_cfg = {**VOC_CONFIG, "generator_params": {
        **VOC_CONFIG["generator_params"], "aux_channels": 63}}
    voc = build_vocoder(voc_cfg, generator=torch.Generator().manual_seed(23))
    voc = voc.fold_weight_norm_().to(dev).eval()
    vsg = signal_generator(voc_cfg)
    df = np.stack([np.repeat(dilated_factor(f, VSR, 4), VHOP) for f in f0])
    f0_d = torch.from_numpy(f0.astype(np.float32))[:, :, None].to(dev)
    df_d = torch.from_numpy(df.astype(np.float32)).to(dev)
    rng = torch.Generator(device=dev).manual_seed(24)
    conv = {}
    for dtype, model in models.items():
        vdt = copy.deepcopy(voc).to(dtype)

        def convert(model=model, vdt=vdt):
            feats = run(model, dev, cpu_in)
            aux = torch.cat([feats[:, :1], feats[:, :1], feats,
                             feats[:, -1:], feats[:, -1:]], 1)
            return vocode(vdt, vsg, f0_d, aux, df_d, generator_rng=rng)
        y = convert()
        require(tuple(y.shape) == (TB2, TF2 * VHOP, 1)
                and torch.isfinite(y).all().item(),
                f"B02 conversion {dtype}: output")
        ms = cuda_ms(convert, iters=3, warmup=1)
        conv[str(dtype)[6:]] = {"batch_ms": ms, "ms_per_utterance": ms / TB2,
                                "audio_s_per_s": TB2 * TF2 * VHOP / VSR
                                / ms * 1e3}
    say(f"B02 conversion (decode + vocode, {TB2} x {TF2 * VHOP / VSR:.2f} s, "
        f"switch off): {conv}")
    return {"fused_conv1d": sum(launches.values())}, {"decode": out,
                                                      "conversion": conv}


# B02 training at egs/svcc23/baseline02/conf/taco2.yaml's width and
# settings (TACO_CONFIG's Tacotron2, the MultiSubFreqDiscriminator's
# 50-frame windows, the optimizers' defaults that build_b02_task shares
# with that file, batch 16 x 400 frames); the phase split and the
# intervals are cut to B02_STEPS gen_steps then B02_STEPS gan_steps, each
# phase a warm-up interval of B02_LOG steps and a timed one
B02_LOG = 1
B02_STEPS = 2 * B02_LOG
TB3, TF3 = 16, 400
B02_TRAIN_CONFIG = {
    **TACO_CONFIG,
    "sampling_rate": 24000,
    "hop_size": HOP,
    "discriminator_type": "MultiSubFreqDiscriminator",
    "discriminator_params": {"batch_max_frames": 50},
    "generator_scheduler_params": {"step_size": 20000, "gamma": 0.5},
    "discriminator_scheduler_params": {"step_size": 20000, "gamma": 0.5},
    "batch_size": TB3,
    "discriminator_train_start_steps": B02_STEPS - 1,  # then gan_step
    "train_max_steps": 2 * B02_STEPS,
    "log_interval_steps": B02_LOG,
    "eval_interval_steps": 100000,
    "save_interval_steps": 2 * B02_STEPS,
}
# (what it is, T, Cin, Cout, dilation) of B02 training's window convs, at
# batch 16: the bap stream's K = 3 convs (conv3 on the T + 2 frames of the
# K = 1, padding-1 conv2) and a FiLM net's 1-channel convs
B02_CONV_SHAPES = [
    ("bap conv0", TF3, 258, 86, 2),
    ("bap conv1", TF3, 86, 43, 2),
    ("bap conv3", TF3 + 2, 21, 3, 2),
    ("FiLM conv", TF3, 1, 1, 1),
]


def b02_dataset(n=24, seed=0):
    """In-memory utterances in B02Dataset's item layout (utt_id, wave, f0,
    ppg, lft, lf0, vuv, mcep, bap, spk_emb), 250-460 frames each (the
    batcher cuts them to 400), normalised features as the recipe's dumps
    hold them."""
    r = np.random.default_rng(seed)
    items = []
    for j in range(n):
        nf = int(r.integers(250, 460))
        f0 = np.where(r.random(nf) > 0.2, r.uniform(80, 400, nf), 0.0)
        items.append((f"spk{j % 4}_utt{j}", np.zeros(1, np.float32),
                      f0.astype(np.float32),
                      r.uniform(0, 1, (nf, 256)).astype(np.float32),
                      r.standard_normal((nf, 1)).astype(np.float32),
                      r.standard_normal((nf, 1)).astype(np.float32),
                      (f0 > 0).astype(np.float32)[:, None],
                      r.standard_normal((nf, 60)).astype(np.float32),
                      r.standard_normal((nf, 3)).astype(np.float32),
                      r.standard_normal((1, 512)).astype(np.float32)))
    return items


def _draws_to(draws, dev):
    """A step's draws (`B02TrainTask.draw`) on `dev`."""
    def to(v):
        if isinstance(v, dict):
            return {k: to(u) for k, u in v.items()}
        if isinstance(v, list):
            return [to(u) for u in v]
        return None if v is None else v.to(dev)
    return to(draws)


def b02_train_phase(dev, phases):
    """Phase 22: B02 training at the recipe's width. (1) one gan_step from
    the seed's weights on 2 x 400 frames, f32 on the card against the CPU
    in f32 and f64 (phase 7's rule), on given draws; (2) two
    gan_steps from one state on the recipe's batch, f32 and bf16, gradients
    bit for bit (cuDNN deterministic); (3) `Trainer.run`, B02_STEPS gen and
    B02_STEPS gan steps on 16 x 400 frames, bf16 (packed wire) and f32,
    with the switch off and, after the "auto" probe, on: finite losses,
    rates, launches per step, peak memory, the checkpoint reloaded into a
    fresh task and into `load_acoustic_model`; the busy share of one bf16
    gan_step; (4) #2-#6 at the bap stream's training shapes against their
    plain versions, with device times, cuDNN's and the bound."""
    from svcc23_fastsvc_tpu_torch.bin.common import deterministic_cudnn
    from svcc23_fastsvc_tpu_torch.config import build_b02_task
    from svcc23_fastsvc_tpu_torch.data.collate import B02Batcher
    from svcc23_fastsvc_tpu_torch.data.wire import WirePacker, to_device
    from svcc23_fastsvc_tpu_torch.ops.conv import (
        decide_conv_lowering,
        set_pallas_conv_mode,
    )
    from svcc23_fastsvc_tpu_torch.ops.fused_conv import (
        bwd_plan,
        fused_conv1d,
        fused_conv1d_bwd,
        fused_conv1d_bwd_plain,
        fused_conv1d_plain,
    )
    from svcc23_fastsvc_tpu_torch.ops.window_conv import (
        fwd_plan,
        wgrad_plan,
        window_conv,
        window_conv_dx,
        window_conv_dx_plain,
        window_conv_plain,
        window_conv_wgrad,
        window_conv_wgrad_plain,
    )
    from svcc23_fastsvc_tpu_torch.train.checkpoint import (
        load_acoustic_model,
        load_checkpoint,
    )
    from svcc23_fastsvc_tpu_torch.train.loop import Trainer

    F = torch.nn.functional
    items = b02_dataset()
    deterministic_cudnn()
    try:
        # (1) one step of each phase against the CPU, f32 and f64
        t = time.perf_counter()
        host = B02Batcher(items, batch_size=2, max_frames=TF3,
                          seed=5).sample_batch()
        cpu_batch = to_device(host, "cpu")
        draw_task = build_b02_task(B02_TRAIN_CONFIG, device="cpu", seed=3)
        gen = torch.Generator().manual_seed(6)
        draws = {"gan": draw_task.draw("gan", cpu_batch, gen)}
        del draw_task
        losses, grads = {}, {}
        # the gan_step only: its G update is the gen_step's (the
        # adversarial term gives G no gradient), and the CPU f64 reference
        # of a second step is the costliest check of the phase
        for phase in ("gan",):
            for label, where, dtype in (("cpu f64", "cpu", torch.float64),
                                        ("cpu f32", "cpu", torch.float32),
                                        ("card f32", dev, torch.float32)):
                task = build_b02_task(B02_TRAIN_CONFIG, device=where, seed=3)
                task.generator.to(dtype)
                task.discriminator.to(dtype)
                log = grads.setdefault(label, [])
                task.g_opt.step = recording(task.g_opt.step, log)
                task.d_opt.step = recording(task.d_opt.step, log)
                b = {k: v.to(dtype) if v.is_floating_point() else v
                     for k, v in to_device(host, where).items()}
                m = getattr(task, f"{phase}_step")(
                    b, _draws_to(draws[phase], where))
                params = [p.detach() for mod in (task.generator,
                                                 task.discriminator)
                          for p in mod.parameters()]
                require(all(torch.isfinite(p).all().item() for p in params),
                        f"B02 updated weights, {phase} {label}: not finite")
                losses.setdefault(label, {}).update(
                    {f"{phase} {k}": float(v) for k, v in m.items()})
                del task
        loss_rows, grad_rows = hold_to_f64(losses, grads,
                                           ("G gan", "D gan"))
        say(f"B02 train step vs CPU f64 (card f32 and CPU f32, B=2 x {TF3} "
            f"frames, gan_step from the seed's weights, given draws): loss "
            f"rel errs (card, cpu f32) {loss_rows}")
        say(f"  gradients: {grad_rows}; card losses {losses['card f32']}")
        phases["b02_train_vs_cpu_s"] = time.perf_counter() - t

        # (2) two gan_steps from one state, bit for bit
        t = time.perf_counter()
        rhost = B02Batcher(items, batch_size=TB3, max_frames=TF3,
                           seed=3).sample_batch()
        rbatch = to_device(rhost, dev)
        repeat = {}
        for dt_name in ("float32", "bfloat16"):
            runs = []
            for _ in range(2):
                task = build_b02_task(
                    {**B02_TRAIN_CONFIG, "compute_dtype": dt_name},
                    device=dev, seed=3)
                log = []
                task.g_opt.step = recording(task.g_opt.step, log)
                task.d_opt.step = recording(task.d_opt.step, log)
                task.gan_step(rbatch)
                runs.append(log)
                del task
            differ = {who: sum(not torch.equal(a, b) for a, b in zip(ga, gb))
                      for who, ga, gb in zip(("G", "D"), *runs)}
            repeat[dt_name] = differ
            require(differ == {"G": 0, "D": 0},
                    f"B02 gan_step {dt_name} twice from one state: gradient "
                    f"tensors that differ {differ}")
        say(f"B02 gan_step twice from one state (B={TB3} x {TF3}): gradient "
            f"tensors that differ {repeat}")
        phases["b02_train_repeat_s"] = time.perf_counter() - t

        # (3) Trainer.run, switch off then on
        t = time.perf_counter()
        counters = (window_conv, window_conv_dx, window_conv_wgrad,
                    fused_conv1d, fused_conv1d_bwd)
        names = ", ".join(c.__name__ for c in counters)
        paths, rates_out = {}, {}
        workdir = tempfile.mkdtemp(prefix="chip_smoke_b02_")
        try:
            for switch in ("0", "auto"):
                set_pallas_conv_mode(switch)
                lowering = decide_conv_lowering(dev)
                require(lowering == ("window" if switch == "0"
                                     else "fused+window"),
                        f"B02 train switch {switch}: lowering {lowering}")
                path = "b02_train" if switch == "0" else "b02_train_fused"
                for c in counters:
                    c.launches = 0
                step_launches = {}
                # with the switch on, bf16 only (phase 26's time)
                for dt_name, wire in (("bfloat16", "packed"),
                                      ("float32", "f32"))[
                                          :2 if switch == "0" else 1]:
                    cfg = {**B02_TRAIN_CONFIG, "compute_dtype": dt_name,
                           "wire_format": wire, "steps_per_call": 1}
                    task = build_b02_task(cfg, device=dev, seed=7)
                    log = []
                    task.gen_step = counted(task.gen_step, counters, log)
                    task.gan_step = counted(task.gan_step, counters, log)
                    batcher = B02Batcher(items, batch_size=TB3,
                                         max_frames=TF3, seed=1)
                    outdir = os.path.join(workdir, f"{path}_{dt_name}")
                    trainer = Trainer(task, batcher, config=cfg,
                                      outdir=outdir)
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    trainer.run()
                    torch.cuda.synchronize()
                    peak = torch.cuda.max_memory_allocated()
                    rates = trainer.history
                    require(all(np.isfinite(v) for x in rates
                                for v in x.values()),
                            f"B02 {path} {dt_name}: non-finite {rates}")
                    n_steps = 2 * B02_STEPS
                    require(task.step == n_steps and len(rates) == 4,
                            f"B02 {path} {dt_name}: {task.step} steps, "
                            f"{len(rates)} logged")
                    ckpt = os.path.join(outdir,
                                        f"checkpoint-{n_steps}steps.pkl")
                    fresh = build_b02_task(cfg, device=dev, seed=99)
                    load_checkpoint(ckpt, fresh)
                    for a, b in ((task.generator, fresh.generator),
                                 (task.discriminator, fresh.discriminator)):
                        for (k, v), w in zip(a.state_dict().items(),
                                             b.state_dict().values()):
                            require(torch.equal(v, w),
                                    f"B02 checkpoint reload: {k}")
                    require(fresh.step == n_steps
                            and fresh.g_opt.count == n_steps
                            and fresh.d_opt.count == n_steps // 2
                            and torch.equal(fresh.rng.get_state(),
                                            task.rng.get_state()),
                            "B02 checkpoint reload: counts, draws")
                    model, steps = load_acoustic_model(ckpt, cfg, device=dev)
                    want = task.generator.state_dict()
                    got = model.state_dict()
                    require(steps == n_steps and set(got) == set(want)
                            and all(torch.equal(v, want[k])
                                    for k, v in got.items()),
                            "B02 checkpoint: load_acoustic_model differs")
                    for phase, warm, timed in (("gen", 0, 1), ("gan", 2, 3)):
                        rates_out[f"{path} {phase} {dt_name}"] = {
                            "steps_per_s": rates[timed]["steps_per_s"],
                            "frames_per_s": rates[timed]["frames_per_s"],
                            "warm_up_interval_steps_per_s":
                                rates[warm]["steps_per_s"],
                            "data_wait_s": rates[timed]["data_wait_s"],
                            "step_wait_s": rates[timed]["step_wait_s"],
                            "drain_s": rates[timed]["drain_s"],
                            "peak_mem_gib": peak / 2 ** 30,
                            f"launches_per_step ({names})":
                                log[B02_LOG * timed],
                        }
                    step_launches[dt_name] = log
                    say(f"B02 train {path} {dt_name} ({wire} wire): mean "
                        f"losses to step " + "; ".join(
                            f"{x['step']}: mse {x['mse_loss']:.4f}"
                            + (f" D {x['discriminator_loss']:.4f}"
                               if "discriminator_loss" in x else "")
                            for x in rates))
                    del task, fresh, trainer, model
                    torch.cuda.empty_cache()
                for dt_name, log in step_launches.items():
                    require(all(row == log[0] for row in log[:B02_STEPS])
                            and all(row == log[B02_STEPS]
                                    for row in log[B02_STEPS:]),
                            f"B02 {path} {dt_name}: launches differ between "
                            f"steps of a phase: {log}")
                    # the kernels of each path, in every step: switch off
                    # #2 #3 #4; on, #5 #6 (and conv0's #2 and #4: 258
                    # channels are past the fused conv's 192)
                    want_on = (0, 2) if switch == "0" else (0, 2, 3, 4)
                    for row in (log[0], log[B02_STEPS]):
                        require(all(row[i] > 0 for i in want_on),
                                f"B02 {path} {dt_name}: a kernel of the "
                                f"path was not launched in a step: {row} "
                                f"({names})")
                    if switch == "0":
                        require(log[0][1] > 0 and log[0][3:] == [0, 0],
                                f"B02 {path}: launches {log[0]} ({names})")
                paths[path] = {c.__name__: c.launches for c in counters}
                say(f"B02 {path} main path: launches {paths[path]}")
        finally:
            set_pallas_conv_mode("0")
            shutil.rmtree(workdir, ignore_errors=True)
        for k, v in rates_out.items():
            say(f"B02 train {k}: {v}")

        # busy share of one bf16 gan_step (switch off)
        cfg = {**B02_TRAIN_CONFIG, "compute_dtype": "bfloat16"}
        task = build_b02_task(cfg, device=dev, seed=7)
        pbatch = to_device(WirePacker(hop_size=HOP)(rhost), dev)
        task.gan_step(pbatch)
        torch.cuda.synchronize()
        t_wall = time.perf_counter()
        for _ in range(2):
            task.gan_step(pbatch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t_wall) * 1e3 / 2
        per_kernel = device_ms(lambda: task.gan_step(pbatch), n=1,
                               host_ops=False)
        busy = sum(per_kernel.values())
        require(busy > 0, "profile B02 gan_step: no device time recorded")
        say(f"profile B02 gan_step bf16 (B={TB3} x {TF3}): wall "
            f"{wall_ms:.3f} ms/step, kernels {busy:.3f} ms, busy "
            f"{busy / wall_ms:.1%}")
        for kname, ms in list(per_kernel.items())[:12]:
            say(f"  {ms:8.4f} ms {ms / busy:6.1%}  {kname[:110]}")
        del task
        phases["b02_train_s"] = time.perf_counter() - t
    finally:
        torch.backends.cudnn.deterministic = False

    # (4) #2-#6 at the bap stream's training shapes
    t = time.perf_counter()
    rows = []
    kgen = torch.Generator(device=dev).manual_seed(22)
    launches = {p: n for p, n in paths.items()}
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        for what, T, cin, cout, dil in B02_CONV_SHAPES:
            x = torch.randn((TB3, T, cin), generator=kgen, device=dev).to(
                dtype)
            g = torch.randn((TB3, T, cout), generator=kgen, device=dev).to(
                dtype)
            w = (torch.randn((3, cin, cout), generator=kgen, device=dev)
                 / (3 * cin) ** 0.5).to(dtype)
            b = (0.1 * torch.randn((cout,), generator=kgen,
                                   device=dev)).to(dtype)
            xt, gt = (v.transpose(1, 2).contiguous() for v in (x, g))
            wt = w.permute(2, 1, 0).contiguous()
            esize = x.element_size()
            ops = 2 * TB3 * T * 3 * cin * cout
            shape = f"({TB3},{T},{cin})->{cout} d={dil}"
            fwd_bytes = (x.numel() + w.numel() + b.numel()
                         + TB3 * T * cout) * esize
            dx_bytes = (g.numel() + w.numel() + x.numel()) * esize
            wg_bytes = (x.numel() + g.numel()) * esize + (w.numel() + cout) * 4
            bwd_bytes = ((2 * x.numel() + g.numel() + w.numel()) * esize
                         + (w.numel() + cout) * 4)
            # conv0's input (the features) takes no gradient: no dx there
            cases = [c for c in [
                ("window_conv", "window_conv.cu", "pallas_window_conv.py:155",
                 "b02_train", fwd_bytes, ops,
                 lambda: window_conv(x, w, b, dil, None),
                 lambda: window_conv_plain(x, w, b, dil, None),
                 lambda: F.conv1d(xt, wt, b, padding=dil, dilation=dil),
                 "F.conv1d", fwd_plan(dtype, TB3, T, cin, cout)["variant"]),
                ("window_conv_dx", "window_conv_grad.cu",
                 "pallas_window_conv.py:252", "b02_train", dx_bytes, ops,
                 lambda: window_conv_dx(g, w, dil),
                 lambda: window_conv_dx_plain(g, w, dil),
                 lambda: torch.nn.grad.conv1d_input(
                     xt.shape, wt, gt, padding=dil, dilation=dil),
                 "torch.nn.grad.conv1d_input",
                 fwd_plan(dtype, TB3, T, cout, cin)["variant"]),
                ("window_conv_wgrad", "window_conv_grad.cu",
                 "pallas_window_conv.py:203", "b02_train", wg_bytes, ops,
                 lambda: window_conv_wgrad(x, g, 3, dil, None),
                 lambda: window_conv_wgrad_plain(x, g, 3, dil, None),
                 lambda: torch.nn.grad.conv1d_weight(
                     xt, wt.shape, gt, padding=dil, dilation=dil),
                 "torch.nn.grad.conv1d_weight",
                 wgrad_plan(dtype, TB3, T, 3, cin, cout)["variant"]),
            ] if not (c[0] == "window_conv_dx" and what == "bap conv0")]
            if max(cin, cout) <= 192:  # the fused conv's width
                cases += [
                    ("fused_conv1d", "fused_conv.cu", "pallas_conv.py:219",
                     "b02_train_fused", fwd_bytes, ops,
                     lambda: fused_conv1d(x, w, b, dil, dil, dil, None),
                     lambda: fused_conv1d_plain(x, w, b, dil, dil, dil, None),
                     lambda: F.conv1d(xt, wt, b, padding=dil, dilation=dil),
                     "F.conv1d", fwd_plan(dtype, TB3, T, cin,
                                          cout)["variant"]),
                    ("fused_conv1d_bwd", "fused_conv.cu", "pallas_conv.py:252",
                     "b02_train_fused", bwd_bytes, 2 * ops,
                     lambda: fused_conv1d_bwd(x, g, w, dil, dil, dil, None),
                     lambda: fused_conv1d_bwd_plain(x, g, w, dil, dil, dil,
                                                    None),
                     lambda: torch.ops.aten.convolution_backward(
                         gt, xt, wt, [cout], [1], [dil], [dil], False, [0],
                         1, [True, True, True]),
                     "torch.ops.aten.convolution_backward, one call",
                     bwd_plan(dtype, TB3, T, 3, cin, cout)["variant"]),
                ]
            for (name, src, line, path, nbytes, n_ops, fn, plain, lib,
                 lib_name, variant) in cases:
                got, want = fn(), plain()
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                torch.cuda.synchronize()
                err = 0.0
                for a, c in zip(got, want):
                    if a is None:
                        continue
                    e = (a.float() - c.float()).abs().max().item()
                    scale = c.float().abs().max().item()
                    require(torch.isfinite(a).all().item(),
                            f"{name} {dt} {what}: non-finite")
                    require(e <= TOL_CONV[dtype] * scale,
                            f"{name} {dt} {what}: max err {e} > "
                            f"{TOL_CONV[dtype]} x {scale}")
                    err = max(err, e)
                b_ms, b_by = bound(nbytes, n_ops, dtype)
                row = {
                    "name": f"{name} {dt} B02 train {what} {shape}",
                    "route": "cuda",
                    "source": f"svcc23_fastsvc_tpu_torch/csrc/{src}",
                    "replaces": f"svcc23_fastsvc_tpu/ops/{line}",
                    "launches": launches[path][name],
                    "max_abs_err": err,
                    "ms": cuda_ms(fn),
                    "plain_ms": cuda_ms(plain, iters=5, warmup=1),
                    "bound_ms": b_ms,
                    "bound_by": b_by,
                    "library_ms": cuda_ms(lib),
                    "library": lib_name,
                    "variant": variant,
                    "device_ms": queued_ms(fn),
                    "library_device_ms": queued_ms(lib),
                }
                rows.append(row)
                say(f"{row['name']}: max err {err:.3e}; {row['ms']:.4f} ms "
                    f"(plain {row['plain_ms']:.4f}, library "
                    f"{row['library_ms']:.4f}, bound {b_ms:.4f} by {b_by}); "
                    f"{variant}, device {row['device_ms']:.4f} ms, library "
                    f"device {row['library_device_ms']:.4f} ms")
            del x, g, w, b, xt, gt, wt
    phases["b02_train_kernels_s"] = time.perf_counter() - t
    return rows, paths


# phase 23: the FastSVC front end (recipe stages 0-3) on the card, then
# decode of phase 4's generator on its features; 8 utterances of 4 s, the
# fourth of them at 24 kHz (resampled on the host), two speakers
FE_UTTS = [(f"spk{'AB'[i // 4]}_{i % 4:03d}", 24000 if i == 3 else SR,
            130.0 + 25 * i) for i in range(8)]
FE_SECONDS = 4.0
FE_TRG = "spkB"  # every utterance is converted to this speaker
# the card's loudness within TOL_FE of max |y| of the CPU f32 result; its
# log-mels, conformer and x-vector outputs by phase 7's rule: within
# F32_FACTOR x the CPU f32's own distance from CPU f64 plus TOL_FE of
# max |f64|; YIN: the voicing of >= 99% of frames equal and F0 within
# 1e-4 relative where both are voiced
TOL_FE, TOL_YIN, YIN_AGREE = 1e-5, 1e-4, 0.99


def fe_singing(f0, sr, seed, seconds=FE_SECONDS):
    r = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    inst = f0 * (1 + 0.03 * np.sin(2 * np.pi * 5.5 * t))
    phase = 2 * np.pi * np.cumsum(inst) / sr
    x = sum(0.5 ** k * np.sin((k + 1) * phase) for k in range(4))
    env = 0.5 * (1 - np.cos(2 * np.pi * np.minimum(t / seconds, 1)))
    return 0.3 * x * env + 0.002 * r.standard_normal(len(t))


def reference_layout_weights(cls, seed):
    """The state dict of a `cls()` made from a seed, batch norm's running
    statistics moved off 0 / 1: what a reference checkpoint holds."""
    torch.manual_seed(seed)
    sd = cls().state_dict()
    gen = torch.Generator().manual_seed(seed + 1)
    for k, v in sd.items():
        if k.endswith("running_mean"):
            v.copy_(0.2 * torch.randn(v.shape, generator=gen))
        elif k.endswith("running_var"):
            v.copy_(torch.rand(v.shape, generator=gen) + 0.5)
    return sd


def hold_f32_to_f64(name, card, cpu32, cpu64):
    """Phase 7's rule on one output: the card's f32 within F32_FACTOR x
    the CPU f32's distance from the CPU f64, plus TOL_FE of max |f64|."""
    ref = cpu64.double()
    e_card = (card.double().cpu() - ref).abs().max().item()
    e_cpu = (cpu32.double() - ref).abs().max().item()
    scale = ref.abs().max().item()
    require(e_card <= F32_FACTOR * e_cpu + TOL_FE * scale,
            f"{name}: card err {e_card}, CPU f32 err {e_cpu}, max |f64| "
            f"{scale}")
    return {"card err": e_card, "cpu f32 err": e_cpu, "max |f64|": scale}


def front_end_phase(dev, phases, g32, sg):
    """Phase 23: recipe stages 0-3 through the port's front end on the
    card, then decode. (1) The main path, launch counts set to 0 before it
    and read after: the utterances written as PCM16 wavs and read through
    a wav.scp, as the CLIs read them; x-vector speaker embeddings
    (`speaker_embeddings`, 512 / 1500 widths, a SpeechBrain-layout
    checkpoint from a seed); `extract_features` per utterance (Harvest on
    the host, loudness and the full-width 16-block conformer PPG, from a
    reference-layout checkpoint, on the card); per-speaker
    `F0Statistics`; the `StandardScaler` fit and transform; every
    utterance converted to FE_TRG by `synthesize` with phase 4's f32
    generator in one batch. (2) The card held against the CPU. (Each
    stage timed alone, the PPG's busy share and a second, warm pass were
    cut when phase 29 came to run these stages through the CLIs.)"""
    from svcc23_fastsvc_tpu_torch.bin.common import (
        iter_wav_scp,
        resample,
        write_wav,
    )
    from svcc23_fastsvc_tpu_torch.bin.decode_fastsvc import (
        PAD_MULTIPLE,
        synthesize,
    )
    from svcc23_fastsvc_tpu_torch.bin.extract_spk_embs import (
        speaker_embeddings,
    )
    from svcc23_fastsvc_tpu_torch.bin.preprocess_fastsvc import (
        extract_features,
        logmel_extract,
    )
    from svcc23_fastsvc_tpu_torch.dsp.f0 import F0Statistics, yin_f0
    from svcc23_fastsvc_tpu_torch.models.conformer_ppg import (
        ConformerPPG,
        frontend_logmel,
        load_ppg_model,
    )
    from svcc23_fastsvc_tpu_torch.models.xvector import (
        XVector,
        load_xvector_model,
    )
    from svcc23_fastsvc_tpu_torch.ops.sine import sine_excitation
    from svcc23_fastsvc_tpu_torch.ops.stft import loudness_extract
    from svcc23_fastsvc_tpu_torch.ops.window_conv import (
        window_conv,
        window_conv_dx,
        window_conv_wgrad,
    )
    from svcc23_fastsvc_tpu_torch.utils.scalers import StandardScaler

    t = time.perf_counter()
    cfg = {"sampling_rate": SR, "hop_size": HOP, "lft_hop_size": 64,
           "shiftms": 10}
    audio_s = len(FE_UTTS) * FE_SECONDS
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fe_")
    try:
        scp = os.path.join(tmp, "wav.scp")
        with open(scp, "w") as f:
            for i, (utt, sr, f0) in enumerate(FE_UTTS):
                path = os.path.join(tmp, f"{utt}.wav")
                write_wav(path, fe_singing(f0, sr, i), sr)
                f.write(f"{utt} {path}\n")
        ppg_path = os.path.join(tmp, "24epoch.pth")
        torch.save(reference_layout_weights(ConformerPPG, 10), ppg_path)
        xv_path = os.path.join(tmp, "embedding_model.ckpt")
        torch.save(reference_layout_weights(XVector, 20), xv_path)
        ppg_model = load_ppg_model(ppg_path, device=dev)
        xvector = load_xvector_model(xv_path, device=dev)
        utts = list(iter_wav_scp(scp))
        phases["front_end_setup_s"] = time.perf_counter() - t

        # (1) the main path, front end then decode
        counters = (window_conv, window_conv_dx, window_conv_wgrad,
                    sine_excitation)
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t_path = time.perf_counter()
        embs = speaker_embeddings(scp, "xvector", checkpoint=xv_path,
                                  device=dev)
        feats = {utt: extract_features(
            utt, audio, sr, cfg, f0min=70.0, f0max=400.0,
            linguistic="conformer", ppg_model=ppg_model, device=dev)
            for utt, audio, sr in utts}
        torch.cuda.synchronize()
        front_end_s = time.perf_counter() - t_path
        fe_peak = torch.cuda.max_memory_allocated()
        stats = F0Statistics()
        f0_stats = {}
        for spk in sorted({u.split("_")[0] for u in feats}):
            f0_stats[spk] = stats.estimate(
                [f["f0"] for u, f in feats.items() if u.startswith(spk)])
        scaler = StandardScaler()
        for f in feats.values():
            scaler.partial_fit(f["ppg"])
        trg = np.array([f0_stats[FE_TRG][0], 1.0])
        Tf = max(len(f["f0"]) for f in feats.values())
        Tp = -(-Tf // PAD_MULTIPLE) * PAD_MULTIPLE
        nb = len(feats)
        ppg_p = np.zeros((nb, Tp, 144), np.float32)
        f0_p = np.zeros((nb, Tp, 1), np.float32)
        lft_p = np.zeros((nb, Tp * HOP, 1), np.float32)
        for bi, (utt, f) in enumerate(feats.items()):
            n = len(f["f0"])
            src = np.array([f0_stats[utt.split("_")[0]][0], 1.0])
            ppg_p[bi, :n] = scaler.transform(f["ppg"])
            f0_p[bi, :n, 0] = stats.convert(f["f0"], src, trg)
            lft_p[bi, :n * HOP, 0] = f["lft"]
        emb_p = np.broadcast_to(embs[FE_TRG], (nb, 512)).copy()
        rng = torch.Generator(device=dev).manual_seed(3)
        y = synthesize(g32, sg, *(torch.from_numpy(a).to(dev) for a in (
            ppg_p, f0_p, lft_p, emb_p)), generator_rng=rng)
        torch.cuda.synchronize()
        path_s = time.perf_counter() - t_path
        launches = {"window_conv": window_conv.launches,
                    "sine_excitation": sine_excitation.launches}
        require(launches == {"window_conv": 60, "sine_excitation": 1}
                and window_conv_dx.launches == window_conv_wgrad.launches
                == 0, f"front end -> decode launched {launches}; want 60 "
                      "window convs and 1 sine")
        require(tuple(y.shape) == (nb, Tp * HOP, 1)
                and torch.isfinite(y).all().item(), "front end -> decode: "
                f"output {tuple(y.shape)} not finite or not ({nb}, "
                f"{Tp * HOP}, 1)")
        for utt, f in feats.items():
            n = len(f["f0"])
            require(f["ppg"].shape == (n, 144) and len(f["wave"]) ==
                    len(f["lft"]) == n * HOP and np.isfinite(
                        f["ppg"]).all() and np.isfinite(f["lft"]).all(),
                    f"features of {utt}: shapes or values")
            require((f["f0"] > 0).mean() > 0.5, f"{utt}: Harvest voiced "
                    f"{(f['f0'] > 0).mean():.2f} of the frames")
        require(all(e.shape == (512,) and np.isfinite(e).all()
                    for e in embs.values()), "x-vectors: shape or values")
        f0_rows = {k: [round(float(x), 4) for x in v]
                   for k, v in f0_stats.items()}
        say(f"front end main path ({len(utts)} x {FE_SECONDS:.0f} s), first "
            f"pass: front end {front_end_s:.3f} s ({audio_s / front_end_s:.2f} audio-s/s)"
            f", with stats, scaler and decode {path_s:.3f} s; frames "
            f"{[len(f['f0']) for f in feats.values()]}; log-F0 mean, std "
            f"{f0_rows}; launches {launches}")
        say(f"front end peak memory: {fe_peak / 2**30:.3f} GiB")
        phases["front_end_path_s"] = time.perf_counter() - t

        # the audio at 16 kHz on the card, for the holds
        a16 = [resample(a, sr, 16000) for _, a, sr in utts]
        x16 = [torch.as_tensor(a, dtype=torch.float32, device=dev)
               for a in a16]

        # (2) the card against the CPU
        t = time.perf_counter()
        holds = {}
        with torch.inference_mode():
            x2 = x16[0][:2 * 16000]
            x2c = x2.cpu()
            for name, model, fn in (
                ("conformer ppg", ppg_model, lambda m, x: m(x)),
                ("x-vector", xvector, lambda m, x: m.encode(x)),
            ):
                cpu32 = copy.deepcopy(model).cpu()
                cpu64 = copy.deepcopy(model).cpu().double()
                holds[name] = hold_f32_to_f64(
                    name, fn(model, x2), fn(cpu32, x2c),
                    fn(cpu64, x2c.double()))
            err = scale = 0.0
            for x in x16:
                ref = loudness_extract(x.cpu(), SR, 64)
                err = max(err, (loudness_extract(x, SR, 64).cpu() - ref)
                          .abs().max().item())
                scale = max(scale, ref.abs().max().item())
            require(err <= TOL_FE * scale, f"loudness: card vs CPU max err "
                    f"{err} > {TOL_FE} x {scale}")
            holds["loudness"] = {"max err": err, "max |y|": scale}
            # log-mel by phase 7's rule: the quiet bins of a loud frame keep
            # only the f32 FFT's error relative to the frame's energy, which
            # the log turns into ~1e-4 nepers on the CPU and the card alike
            for name, fn in (("log-mel", logmel_extract),
                             ("ppg log-mel", frontend_logmel)):
                rows = [hold_f32_to_f64(name, fn(x), fn(x.cpu()),
                                        fn(x.cpu().double())) for x in x16]
                holds[name] = max(rows, key=lambda r: r["card err"])
                holds[name]["card vs cpu f32"] = max(
                    (fn(x).cpu() - fn(x.cpu())).abs().max().item()
                    for x in x16)
            frames = same = both = 0
            f0_err = 0.0
            for x in x16:
                got = yin_f0(x, sr=16000, hop=HOP).cpu()
                ref = yin_f0(x.cpu(), sr=16000, hop=HOP)
                frames += len(ref)
                same += int(((got > 0) == (ref > 0)).sum())
                v = (got > 0) & (ref > 0)
                both += int(v.sum())
                if v.any():
                    f0_err = max(f0_err, ((got[v] - ref[v]).abs()
                                          / ref[v]).max().item())
            holds["yin"] = {"frames": frames, "voicing equal": same,
                            "both voiced": both, "max f0 rel err": f0_err}
            require(same >= YIN_AGREE * frames and f0_err <= TOL_YIN,
                    f"yin card vs CPU: {holds['yin']}")
        for name, h in holds.items():
            say(f"front end hold {name}: {h}")
        phases["front_end_holds_s"] = time.perf_counter() - t
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# phase 24: the B02 recipe from wav to converted wav on the card, at
# egs/svcc23/baseline02/conf/taco2.yaml's settings: 8 utterances of 4 s
# (phase 23's voices, the fourth at 16 kHz, resampled on the host), two
# speakers, every one converted to B02_TRG
B02_FE_UTTS = [(f"spk{'AB'[i // 4]}_{i % 4:03d}", 16000 if i == 3 else VSR,
                130.0 + 25 * i) for i in range(8)]
B02_FE_CONFIG = {"sampling_rate": VSR, "hop_size": VHOP,
                 "shiftms": 6.6666666666, "mcep_dim": 59, "lft_hop_size": 64}
B02_TRG = "spkB"
B02_F0_RANGE = (70.0, 800.0)
# seconds of the first utterance held against the CPU (2.0 until phase 30
# was added: this cut helps pay for it)
HUBERT_HOLD_S = 1.0
B02_VOC_HELD = (0, 7)  # utterances vocoded on the CPU too
HUBERT_SPIN_CYCLES = 400_000_000  # ~0.2 s: outlasts enqueueing 2 forwards
# HuBERT units, mcep, bap and loudness: the card within F32_B02 x the CPU
# f32's own distance from the CPU f64, or TOL_FE x max |f64| where that is
# larger; mel L1 and MCD within TOL_B02_EVAL relative of the CPU's
F32_B02, TOL_B02_EVAL = 2.0, 1e-3


def hold_b02(name, card, cpu32, cpu64):
    """Phase 24's rule on one output (see F32_B02)."""
    ref = torch.as_tensor(cpu64).double()
    e_card = (torch.as_tensor(card).double().cpu() - ref).abs().max().item()
    e_cpu = (torch.as_tensor(cpu32).double() - ref).abs().max().item()
    scale = ref.abs().max().item()
    require(e_card <= max(F32_B02 * e_cpu, TOL_FE * scale),
            f"{name}: card err {e_card}, CPU f32 err {e_cpu}, max |f64| "
            f"{scale}")
    return {"card err": e_card, "cpu f32 err": e_cpu, "max |f64|": scale}


def b02_front_end_phase(dev, phases):
    """Phase 24: the B02 recipe, stages 0-3 then conversion, on the card.
    (1) The main path, launch counts set to 0 before it and read after:
    the utterances written as PCM16 wavs and read through a wav.scp;
    phase 23's x-vector speaker embeddings; `extract_b02_features` per
    utterance (Harvest on the host; WORLD analysis, loudness and
    HuBERT-soft at bshall's full width, from a seeded checkpoint in
    bshall's layout read by `load_hubert_soft`, on the card); the B02
    scalers fitted and applied in memory; every utterance shifted to
    B02_TRG's mean log-F0 in whole semitones, decoded in one batch by
    phase 20's full-width Tacotron2 (`decode_batch`) and vocoded by phase
    20's HN-uSFGAN (`vocode`); mel L1 and MCD of each conversion against
    its source (`evaluate.pair_metrics`) on the card. (2) The card held
    against the CPU. (Each stage timed alone, HuBERT's busy share and a
    second, warm pass were cut when phase 29 came to run these stages
    through the CLIs.)"""
    from svcc23_fastsvc_tpu_torch.bin.common import (
        iter_wav_scp,
        resample,
        write_wav,
    )
    from svcc23_fastsvc_tpu_torch.bin.compute_statistics_b02 import (
        fit_b02_scalers,
    )
    from svcc23_fastsvc_tpu_torch.bin.decode_b02 import (
        decode_batch,
        semitone_shift,
    )
    from svcc23_fastsvc_tpu_torch.bin.evaluate import pair_metrics
    from svcc23_fastsvc_tpu_torch.bin.extract_spk_embs import (
        speaker_embeddings,
    )
    from svcc23_fastsvc_tpu_torch.bin.normalize_b02 import (
        normalize_b02_features,
    )
    from svcc23_fastsvc_tpu_torch.bin.preprocess_b02 import (
        extract_b02_features,
        world_hop,
    )
    from svcc23_fastsvc_tpu_torch.bin.synthesize_b02 import (
        signal_generator,
        vocode,
    )
    from svcc23_fastsvc_tpu_torch.config import (
        build_acoustic_model,
        build_vocoder,
    )
    from svcc23_fastsvc_tpu_torch.dsp.f0 import F0Statistics, dilated_factor
    from svcc23_fastsvc_tpu_torch.dsp.harvest import harvest_f0
    from svcc23_fastsvc_tpu_torch.dsp.world import world_analyze
    from svcc23_fastsvc_tpu_torch.models.hubert import (
        HubertSoft,
        bshall_checkpoint,
        load_hubert_soft,
    )
    from svcc23_fastsvc_tpu_torch.models.xvector import XVector
    from svcc23_fastsvc_tpu_torch.ops.down_chain import down_chain_fwd
    from svcc23_fastsvc_tpu_torch.ops.fused_conv import fused_conv1d
    from svcc23_fastsvc_tpu_torch.ops.pd_block import (
        pd_adaptive_block,
        pd_fixed_block,
        pd_fixed_chain,
    )
    from svcc23_fastsvc_tpu_torch.ops.sine import sine_excitation
    from svcc23_fastsvc_tpu_torch.ops.stft import loudness_extract_frames
    from svcc23_fastsvc_tpu_torch.ops.window_conv import (
        window_conv,
        window_conv_dx,
        window_conv_wgrad,
    )

    t = time.perf_counter()
    cfg = B02_FE_CONFIG
    f0min, f0max = B02_F0_RANGE
    audio_s = len(B02_FE_UTTS) * FE_SECONDS
    tmp = tempfile.mkdtemp(prefix="chip_smoke_b02_")
    try:
        scp = os.path.join(tmp, "wav.scp")
        with open(scp, "w") as f:
            for i, (utt, sr, f0) in enumerate(B02_FE_UTTS):
                path = os.path.join(tmp, f"{utt}.wav")
                write_wav(path, fe_singing(f0, sr, 40 + i), sr)
                f.write(f"{utt} {path}\n")
        xv_path = os.path.join(tmp, "embedding_model.ckpt")
        torch.save(reference_layout_weights(XVector, 20), xv_path)
        torch.manual_seed(24)
        hubert_path = os.path.join(tmp, "hubert-soft-0d54a1f4.pt")
        torch.save(bshall_checkpoint(HubertSoft(), seed=24), hubert_path)
        hubert = load_hubert_soft(hubert_path, device=dev)
        taco = build_acoustic_model(
            TACO_CONFIG, generator=torch.Generator().manual_seed(20)).eval()
        taco_cpu = copy.deepcopy(taco)
        taco = taco.to(dev)
        voc_cfg = {**VOC_CONFIG, "generator_params": {
            **VOC_CONFIG["generator_params"], "aux_channels": 63}}
        voc = build_vocoder(voc_cfg, generator=torch.Generator().manual_seed(
            23)).fold_weight_norm_().eval()
        voc_cpu = copy.deepcopy(voc)
        voc = voc.to(dev)
        vsg = signal_generator(voc_cfg)
        utts = list(iter_wav_scp(scp))
        phases["b02_front_end_setup_s"] = time.perf_counter() - t

        def front_end():
            """Stages 0-3: (features by utterance, scalers, normalised)."""
            embs = speaker_embeddings(scp, "xvector", checkpoint=xv_path,
                                      device=dev)
            feats = {}
            for utt, audio, sr in utts:
                feats[utt] = extract_b02_features(
                    utt, audio, sr, cfg, f0min=f0min, f0max=f0max,
                    linguistic="hubert", ppg_model=hubert, device=dev)
                feats[utt]["spk_emb"] = embs[utt.split("_")[0]][None]
            scalers = fit_b02_scalers(feats.values())
            norm = {u: normalize_b02_features(f, scalers)
                    for u, f in feats.items()}
            return embs, feats, norm

        def conversion_inputs(embs, feats, norm):
            """Decode inputs on the card, every utterance shifted to
            B02_TRG and padded to the longest: ppg, lengths, lft, lf0, the
            target's embedding, f0 and the dilation factors."""
            stats = F0Statistics()
            lf0_mean = {spk: stats.estimate(
                [f["f0"] for u, f in feats.items() if u.startswith(spk)])[0]
                for spk in sorted({u.split("_")[0] for u in feats})}
            lengths = [len(f["f0"]) for f in feats.values()]
            nb, tp = len(feats), max(lengths)
            ppg = np.zeros((nb, tp, 256), np.float32)
            lft = np.zeros((nb, tp, 1), np.float32)
            lf0 = np.zeros((nb, tp, 1), np.float32)
            f0 = np.zeros((nb, tp), np.float32)
            for bi, (utt, f) in enumerate(feats.items()):
                n = lengths[bi]
                ratio = 2.0 ** (semitone_shift(
                    lf0_mean[utt.split("_")[0]], lf0_mean[B02_TRG]) / 12.0)
                ppg[bi, :n] = norm[utt]["ppg"]
                lft[bi, :n] = norm[utt]["lft"]
                lf0[bi, :n] = norm[utt]["lf0"] * ratio  # decode_b02's shift
                f0[bi, :n] = f["f0"][:, 0] * ratio
            emb = np.broadcast_to(embs[B02_TRG], (nb, 512)).copy()
            df = np.stack([np.repeat(dilated_factor(x, VSR, 4), VHOP)
                           for x in f0]).astype(np.float32)
            return {"ppg": ppg, "lengths": np.asarray(lengths), "lft": lft,
                    "lf0": lf0, "emb": emb, "f0": f0[:, :, None], "df": df}

        masks_gen = torch.Generator().manual_seed(25)
        vrng = torch.Generator(device=dev)

        def convert(inp, masks, model=None, vocoder=None, where=dev):
            """(mcep | bap (B, T, 63), audio (B, T * hop, 1)) of the
            decode and the vocoder on `where`."""
            d = {k: torch.from_numpy(v).to(where) for k, v in inp.items()}
            feats = decode_batch(model or taco, d["ppg"], d["lengths"],
                                 d["lft"], d["lf0"], d["emb"],
                                 prenet_masks=masks.to(where))
            aux = torch.cat([feats[:, :1], feats[:, :1], feats,
                             feats[:, -1:], feats[:, -1:]], 1)
            return feats, vocode(vocoder or voc, vsg, d["f0"], aux, d["df"],
                                 generator_rng=vrng)

        def evaluate_all(feats, inp, y):
            """mel L1 and MCD of each conversion against its source."""
            return {utt: pair_metrics(
                f["wave"], VSR, y[bi, :inp["lengths"][bi] * VHOP, 0].cpu()
                .numpy(), VSR, device=dev)
                for bi, (utt, f) in enumerate(feats.items())}

        # (1) the main path, stages 0-3 then conversion and evaluation
        counters = (window_conv, window_conv_dx, window_conv_wgrad,
                    sine_excitation, pd_fixed_block, pd_adaptive_block,
                    pd_fixed_chain, fused_conv1d, down_chain_fwd)
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t_path = time.perf_counter()
        embs, feats, norm = front_end()
        torch.cuda.synchronize()
        front_end_s = time.perf_counter() - t_path
        inp = conversion_inputs(embs, feats, norm)
        nb, tp = inp["ppg"].shape[:2]
        masks = taco.prenet_masks(tp, nb, generator=masks_gen)
        vrng.manual_seed(26)
        vstate = vrng.get_state()
        mb, y = convert(inp, masks)
        metrics = evaluate_all(feats, inp, y)
        torch.cuda.synchronize()
        path_s = time.perf_counter() - t_path
        peak = torch.cuda.max_memory_allocated()
        launches = {c.__name__: c.launches for c in counters}
        ran = ("window_conv", "sine_excitation", "pd_fixed_block",
               "pd_adaptive_block")
        require(all(launches[k] > 0 for k in ran)
                and all(v == 0 for k, v in launches.items() if k not in ran),
                f"B02 front end -> conversion launched {launches}; want "
                f"each of {ran} and nothing else")
        require(tuple(mb.shape) == (nb, tp, 63) and tuple(y.shape) == (
            nb, tp * VHOP, 1) and torch.isfinite(mb).all().item()
            and torch.isfinite(y).all().item(),
            f"conversion output {tuple(mb.shape)}, {tuple(y.shape)}")
        for utt, f in feats.items():
            n = len(f["f0"])
            require(f["ppg"].shape == (n, 256) and f["mcep"].shape == (n, 60)
                    and f["bap"].shape == (n, 3) and all(
                        f[k].shape == (n, 1) for k in ("lf0", "vuv", "lft"))
                    and all(np.isfinite(f[k]).all() for k in f),
                    f"B02 features of {utt}: shapes or values")
            require(f["vuv"].mean() > 0.5, f"{utt}: Harvest voiced "
                    f"{f['vuv'].mean():.2f} of the frames")
        require(all(np.isfinite(v).all() and v[0] > 0
                    for v in metrics.values()), f"metrics {metrics}")
        mel = np.mean([v[0] for v in metrics.values()])
        mcd = np.mean([v[1] for v in metrics.values()])
        say(f"B02 front end -> conversion ({nb} x {FE_SECONDS:.0f} s), first "
            f"pass: front end {front_end_s:.3f} s ({audio_s / front_end_s:.2f}"
            f" audio-s/s), with scalers, decode, vocoder and metrics "
            f"{path_s:.3f} s ({audio_s / path_s:.2f} audio-s/s); frames "
            f"{inp['lengths'].tolist()}; mel L1 {mel:.4f}, MCD {mcd:.3f} dB "
            f"(random weights); launches {launches}")
        say(f"B02 front end -> conversion peak memory: {peak / 2**30:.3f} GiB")
        phases["b02_front_end_path_s"] = time.perf_counter() - t

        # the audio and Harvest F0 of each utterance, for the holds
        hop = world_hop(VSR, cfg["shiftms"])
        a24 = [resample(a, sr, VSR) for _, a, sr in utts]
        x16 = [torch.as_tensor(resample(a, sr, 16000), dtype=torch.float32,
                               device=dev) for _, a, sr in utts]
        f0s = [harvest_f0(a, fs=VSR, f0_floor=f0min, f0_ceil=f0max,
                          frame_period_ms=cfg["shiftms"]).astype(np.float32)
               for a in a24]

        # (2) the card against the CPU (f32 and f64)
        t = time.perf_counter()
        holds = {}
        with torch.inference_mode():
            x2 = x16[0][:int(HUBERT_HOLD_S * 16000)]
            holds["hubert units"] = hold_b02(
                "hubert units", hubert(x2), copy.deepcopy(hubert).cpu()(
                    x2.cpu()), copy.deepcopy(hubert).cpu().double()(
                    x2.cpu().double()))
            rows = {"mcep": [], "bap": [], "loudness": []}
            same = frames = 0
            for a, f0, f in zip(a24, f0s, feats.values()):
                # the pipeline's analysis (f64 compute) on the card, against
                # the CPU's f32 and f64
                kw = dict(fs=VSR, hop=hop)
                got = world_analyze(a, f0, device=dev, **kw)
                c32 = world_analyze(a, f0, device="cpu", dtype=torch.float32,
                                    **kw)
                c64 = world_analyze(a, f0, device="cpu", **kw)
                for k, i in (("mcep", 0), ("bap", 1)):
                    rows[k].append(hold_b02(k, got[i], c32[i], c64[i]))
                # continuous log-F0 and V/UV, here and on the main path
                n = len(f["lf0"])
                same += int(np.array_equal(got[2], c32[2])
                            and np.array_equal(got[3], c32[3])
                            and np.array_equal(f["lf0"][:, 0], c32[2][:n])
                            and np.array_equal(f["vuv"][:, 0], c32[3][:n]))
                frames += len(f0)
                xa = torch.as_tensor(a, dtype=torch.float32)
                rows["loudness"].append(hold_b02(
                    "loudness", loudness_extract_frames(xa.to(dev), VSR,
                                                        VHOP),
                    loudness_extract_frames(xa, VSR, VHOP),
                    loudness_extract_frames(xa.double(), VSR, VHOP)))
            for k, r in rows.items():
                holds[k] = max(r, key=lambda h: h["card err"])
            require(same == len(a24), f"continuous lf0 / V/UV differ on "
                    f"{len(a24) - same} utterances")
            holds["lf0 and vuv"] = f"equal on all {frames} frames"

            # the conversion: decode on the CPU on the same prenet masks by
            # phase 20's rule; the vocoder on utterances B02_VOC_HELD fed
            # the card's mcep | bap and the excitation the card drew
            cpu_in = {k: torch.from_numpy(v) for k, v in inp.items()}
            mb_cpu = decode_batch(taco_cpu, cpu_in["ppg"], cpu_in["lengths"],
                                  cpu_in["lft"], cpu_in["lf0"],
                                  cpu_in["emb"], prenet_masks=masks)
            scale = mb_cpu.abs().max().item()
            err = (mb.cpu() - mb_cpu).abs().max().item()
            dec = {"err / max |y|": err / scale, "held to": "CPU f32, "
                   f"limit {TOL_DECODE[torch.float32]}"}
            if err > TOL_DECODE[torch.float32] * scale:
                mb64 = decode_batch(copy.deepcopy(taco_cpu).double(),
                                    *(cpu_in[k].double() if k != "lengths"
                                      else cpu_in[k] for k in (
                                          "ppg", "lengths", "lft", "lf0",
                                          "emb")), prenet_masks=masks)
                e64 = (mb.cpu().double() - mb64).abs().max().item()
                e32 = (mb_cpu.double() - mb64).abs().max().item()
                dec = {"err / max |y|": e64 / scale, "held to": f"CPU f64, "
                       f"limit {F32_FACTOR} x {e32 / scale:.3e}"}
                require(e64 <= F32_FACTOR * e32, f"B02 conversion decode: "
                        f"{dec}")
            holds["conversion decode"] = dec
            sel = list(B02_VOC_HELD)
            replay = torch.Generator(device=dev)
            replay.set_state(vstate)
            exc = vsg(torch.from_numpy(inp["f0"]).to(dev), replay)[sel].cpu()
            aux = torch.cat([mb[:, :1], mb[:, :1], mb, mb[:, -1:],
                             mb[:, -1:]], 1)[sel].cpu()
            y_cpu, _ = voc_cpu(exc, aux, cpu_in["df"][sel])
            scale = y_cpu.abs().max().item()
            err = (y[sel].cpu() - y_cpu).abs().max().item()
            holds["conversion vocoder"] = {
                "utterances": sel, "err / max |y|": err / scale,
                "limit": TOL_DECODE[torch.float32]}
            require(err <= TOL_DECODE[torch.float32] * scale,
                    f"B02 conversion vocoder: {holds['conversion vocoder']}")
            worst = 0.0
            for bi, (utt, f) in enumerate(feats.items()):
                cpu_m = pair_metrics(
                    f["wave"], VSR, y[bi, :inp["lengths"][bi] * VHOP, 0]
                    .cpu().numpy(), VSR, device="cpu")
                worst = max(worst, *(abs(c - g) / abs(c) for c, g in zip(
                    cpu_m, metrics[utt])))
            holds["mel L1 and MCD"] = {"max rel err": worst,
                                       "limit": TOL_B02_EVAL}
            require(worst <= TOL_B02_EVAL, f"metrics card vs CPU: {worst}")
        for name, h in holds.items():
            say(f"B02 front end hold {name}: {h}")
        phases["b02_front_end_holds_s"] = time.perf_counter() - t
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {k: v for k, v in launches.items() if v}


# phases 25-28: the trainer's remaining surface. Phase 25: the recipe's own
# conf/fastsvc.yaml (loader_threads 4, steps_per_call 8, bf16, packed wire)
# with the phase split and the intervals cut to LOADER_STEPS gen steps and
# two intervals of gan steps
RECIPE_YAML = os.path.join("egs", "svcc23", "fastsvc1", "conf", "fastsvc.yaml")
LOADER_STEPS = KSTEPS
LOADER_SCHEDULE = {
    "discriminator_train_start_steps": LOADER_STEPS - 1,  # then gan calls
    "train_max_steps": 3 * LOADER_STEPS,
    "log_interval_steps": LOADER_STEPS,
    "eval_interval_steps": 100000,
    "save_interval_steps": 3 * LOADER_STEPS,
}


def loader_phase(dev, items, counters):
    """Phase 25: `Trainer.run` on conf/fastsvc.yaml as it is (schedule cut)
    with the batches from the CLI's `make_train_batcher`: `loader_threads`
    4 must give the native producer, which the trainer must take batches
    from; then `loader_threads` 1 (the batcher behind the prefetch thread).
    The timed interval is the second of gan calls: steps/s, audio-s/s and
    the data wait of each; launches of #1-#4 counted over both runs."""
    from svcc23_fastsvc_tpu_torch.bin.train_fastsvc import make_train_batcher
    from svcc23_fastsvc_tpu_torch.config import build_train_task, load_config
    from svcc23_fastsvc_tpu_torch.data.collate import FastSVCBatcher
    from svcc23_fastsvc_tpu_torch.data.native_batch import NativeBatchProducer
    from svcc23_fastsvc_tpu_torch.train.loop import Trainer

    recipe = load_config(os.path.join(ROOT, RECIPE_YAML))
    require(recipe["loader_threads"] == 4
            and recipe["steps_per_call"] == KSTEPS
            and recipe["compute_dtype"] == "bfloat16",
            f"{RECIPE_YAML}: loader_threads {recipe['loader_threads']}, "
            f"steps_per_call {recipe['steps_per_call']}")
    for c in counters:
        c.launches = 0
    rates = {}
    workdir = tempfile.mkdtemp(prefix="chip_smoke_loader_")
    try:
        for threads in (recipe["loader_threads"], 1):
            cfg = {**recipe, **LOADER_SCHEDULE, "loader_threads": threads}
            task = build_train_task(cfg, device=dev, seed=7)
            src = make_train_batcher(cfg, lambda seed: FastSVCBatcher(
                items, batch_size=cfg["batch_size"],
                batch_length=cfg["batch_length"], hop_size=cfg["hop_size"],
                seed=seed), 1)
            native = isinstance(src, NativeBatchProducer)
            require(native == (threads > 1),
                    f"loader_threads {threads}: built {type(src).__name__}")
            trainer = Trainer(task, src, config=cfg,
                              outdir=os.path.join(workdir, str(threads)))
            try:
                trainer.run()
            finally:
                if native:
                    src.close()
            torch.cuda.synchronize()
            hist = trainer.history
            require(task.step == 3 * LOADER_STEPS and len(hist) == 3
                    and trainer.call_sizes == [KSTEPS] * 3,
                    f"loader {threads}: {task.step} steps, calls "
                    f"{trainer.call_sizes}")
            require(all(np.isfinite(v) for x in hist for v in x.values()),
                    f"loader {threads}: non-finite {hist}")
            if native:
                # every batch of the run came from the producer's ring
                require(src.batches == 3 * LOADER_STEPS,
                        f"the native producer handed out {src.batches} "
                        f"batches for {3 * LOADER_STEPS} steps")
            timed = hist[-1]
            rates[f"loader_threads {threads}"] = {
                "producer": type(src).__name__,
                "steps_per_s": timed["steps_per_s"],
                "audio_s_per_s": timed["audio_s_per_s"],
                "data_wait_s": timed["data_wait_s"],
                "step_wait_s": timed["step_wait_s"],
                "drain_s": timed["drain_s"],
                "batches_from_producer": getattr(src, "batches", None),
            }
            say(f"loader_threads {threads} ({type(src).__name__}): calls "
                f"{trainer.call_sizes}, mean losses " + "; ".join(
                    f"{x['step']}: G {x['generator_loss']:.4f}" for x in hist))
            del task, trainer, src
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    launches = {c.__name__: c.launches for c in counters}
    require(all(n > 0 for n in launches.values()),
            f"a kernel was not launched on the loader's path: {launches}")
    for k, v in rates.items():
        say(f"train K = {KSTEPS} bf16 (the recipe's yaml), {k}: {v}")
    say(f"loader main path: launches counted at capture {launches}")
    return launches, rates


B02_KS = (2, 4)  # steps a call of the captured B02 calls


def _b02_differing(a, b):
    """Tensors of two B02TrainTasks' training state that differ."""
    for opt in (a.g_opt, a.d_opt, b.g_opt, b.d_opt):
        opt._init_state()
    n = {who: sum(not torch.equal(u, v) for u, v in zip(
        x.state_dict().values(), y.state_dict().values()))
        for who, x, y in (("G", a.generator, b.generator),
                          ("D", a.discriminator, b.discriminator))}
    n["moments"] = sum(not torch.equal(u, v)
                       for o, q in ((a.g_opt, b.g_opt), (a.d_opt, b.d_opt))
                       for u, v in zip(o.mu + o.nu, q.mu + q.nu))
    n["draws generator"] = int(not torch.equal(a.rng.get_state(),
                                               b.rng.get_state()))
    n["counts"] = int((a.step, a.g_opt.count, a.d_opt.count)
                      != (b.step, b.g_opt.count, b.d_opt.count))
    return n


def b02_k_step_phase(dev, counters):
    """Phase 26: B02 training at K steps a call as captured CUDA graphs, at
    phase 22's width and batch (16 x 400 frames), cuDNN deterministic: bf16
    (packed wire) a captured 2-step gen call then a 4-step gan call, f32
    (plain batches, no wire packing) a 2-step gan call, each against K
    eager steps from the same state, metrics and G, D (batch-norm
    statistics included), moments, counts and the draws' generator bit for
    bit; the capture's seconds (its eager warm-up step included), the
    memory the capture leaves reserved, steps/s of a replayed call against
    the eager steps' and its busy share (replay event time over wall)."""
    from svcc23_fastsvc_tpu_torch.bin.common import deterministic_cudnn
    from svcc23_fastsvc_tpu_torch.config import build_b02_task
    from svcc23_fastsvc_tpu_torch.data.collate import B02Batcher
    from svcc23_fastsvc_tpu_torch.data.wire import WirePacker, to_device
    from svcc23_fastsvc_tpu_torch.train.graphs import StepGraphs
    from svcc23_fastsvc_tpu_torch.train.loop import _stack

    items = b02_dataset()
    deterministic_cudnn()
    for c in counters:
        c.launches = 0
    report = {}
    try:
        for dt_name, wire in (("bfloat16", "packed"), ("float32", "f32")):
            cfg = {**B02_TRAIN_CONFIG, "compute_dtype": dt_name,
                   "wire_format": wire}
            pack = (WirePacker(hop_size=HOP) if wire == "packed"
                    else (lambda b: b))
            batcher = B02Batcher(items, batch_size=TB3, max_frames=TF3,
                                 seed=5)
            # bf16: a gen call at K = 2, then a gan call at 4; f32: a gan
            # call at K = 2; each from the state the one before left, equal
            # in both tasks
            calls = ((B02_KS[0], "gen"), (B02_KS[1], "gan")) \
                if dt_name == "bfloat16" else ((B02_KS[0], "gan"),)
            eager = build_b02_task(cfg, device=dev, seed=7)
            graphed = build_b02_task(cfg, device=dev, seed=7)
            graphs = StepGraphs(graphed)
            captured = []
            # (1) each call against K eager steps from the same state
            for K, phase in calls:
                host = [batcher.sample_batch() for _ in range(K)]
                stacked = pack(_stack(host))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                want = [getattr(eager, f"{phase}_step")(
                    to_device(pack(b), dev)) for b in host]
                torch.cuda.synchronize()
                eager_s = (time.perf_counter() - t0) / K
                # what the capture leaves reserved: the graph's pool
                torch.cuda.empty_cache()
                reserved0 = torch.cuda.memory_reserved()
                t0 = time.perf_counter()
                graph = graphs.stage(phase, stacked)
                graphs._capture(graph)
                torch.cuda.synchronize()
                capture_s = time.perf_counter() - t0
                torch.cuda.empty_cache()
                pool_gib = (torch.cuda.memory_reserved()
                            - reserved0) / 2 ** 30
                got = graphs.replay(graph)
                torch.cuda.synchronize()
                row = {
                    "metrics that differ": sum(
                        not torch.equal(v, torch.stack([m[n] for m in want]))
                        for n, v in got.items()),
                    "state that differs": _b02_differing(eager, graphed),
                    "capture_s (warm-up step included)": capture_s,
                    "pool_gib (reserved after the capture)": pool_gib,
                    "eager_s_per_step": eager_s,
                }
                require(all(torch.isfinite(v).all().item()
                            for v in got.values()),
                        f"B02 K = {K} {phase} {dt_name}: non-finite")
                require(row["metrics that differ"] == 0
                        and not any(row["state that differs"].values()),
                        f"B02 K = {K} {phase} {dt_name}: the replay differs "
                        f"from {K} eager steps: {row}")
                report[f"{dt_name} K = {K} {phase}"] = row
                captured.append((K, phase, graph, stacked, row))
            # (2) the replayed calls as the trainer makes them (the states
            # part from here on)
            for K, phase, graph, stacked, row in captured:
                t0 = time.perf_counter()
                # one timed call (two until phase 30 was added: this cut
                # helps pay for it)
                graphs.replay(graphs.stage(phase, stacked))
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t0
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
                graph.graph.replay()
                end.record()
                end.synchronize()
                replay_s = start.elapsed_time(end) / 1e3
                row.update({
                    "steps_per_s K-step call": K / wall_s,
                    "steps_per_s eager (K = 1)": 1 / row["eager_s_per_step"],
                    "call_wall_s": wall_s,
                    "replay_event_s": replay_s,
                    "busy": replay_s / wall_s,
                })
                say(f"B02 {dt_name} ({wire} wire) K = {K} {phase} call "
                    f"(B={TB3} x {TF3}): {row}")
            del eager, graphed, graphs, graph, captured
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    launches = {c.__name__: c.launches for c in counters}
    require(all(n > 0 for n in launches.values()),
            f"a kernel was not launched in the B02 K-step calls: {launches}")
    say(f"B02 K-step main path: launches counted at capture {launches}")
    return launches, report


# phase 27: the FastSVC step with the HiFiGAN discriminator at the JAX
# model's from_config defaults (3 scales; periods 2, 3, 5, 7, 11)
HIFIGAN_CONFIG = {**TRAIN_CONFIG,
                  "discriminator_type":
                      "HiFiGANMultiScaleMultiPeriodDiscriminator",
                  "discriminator_params": {}}
# (what it is, T, Cin, Cout, K) of its stride-1 convs on the window-conv
# kernels at a gan_step's scale 0 (real | fake, 2 x 32 rows), and the
# MelGAN discriminator's two that the wider gate took with them
HIFIGAN_SHAPES = [
    ("HiFiGAN MSD conv 0", 16000, 1, 128, 15),
    ("HiFiGAN MSD conv 6", 16000 // 64, 1024, 1024, 5),
    ("HiFiGAN MSD last", 16000 // 64, 1024, 1, 3),
    ("MelGAN MSD conv 4", 16000 // 64, 512, 512, 5),
    ("MelGAN MSD last", 16000 // 64, 512, 1, 3),
]


def hifigan_phase(dev, items, counters):
    """Phase 27: (1) one gan_step of the recipe's generator with the
    HiFiGAN MSD + MPD on the card against the CPU in f32 and f64 (phase 7's
    rule), then two gan_steps from one state bit for bit, f32 and bf16;
    (2) one bf16 and one f32 gan_step on the recipe's batch with the
    launch counts set to 0 before; (3) #2-#4 at the discriminators' stride-1
    convs against their plain versions, with their times, device times,
    cuDNN's and the bound."""
    from svcc23_fastsvc_tpu_torch.bin.common import deterministic_cudnn
    from svcc23_fastsvc_tpu_torch.config import build_train_task
    from svcc23_fastsvc_tpu_torch.data.collate import FastSVCBatcher
    from svcc23_fastsvc_tpu_torch.data.wire import to_device
    from svcc23_fastsvc_tpu_torch.ops.window_conv import (
        fwd_plan,
        wgrad_plan,
        window_conv,
        window_conv_dx,
        window_conv_dx_plain,
        window_conv_plain,
        window_conv_wgrad,
        window_conv_wgrad_plain,
    )

    deterministic_cudnn()
    try:
        held = train_vs_cpu(dev, items, what="HiFiGAN ",
                            config=HIFIGAN_CONFIG, steps=("gan",))
        for c in counters:
            c.launches = 0
        batch = to_device(FastSVCBatcher(
            items, batch_size=TB, batch_length=16000, hop_size=HOP,
            seed=4).sample_batch(), dev)
        step_rows = {}
        for dt_name in ("bfloat16", "float32"):
            task = build_train_task({**HIFIGAN_CONFIG,
                                     "compute_dtype": dt_name},
                                    device=dev, seed=7)
            before = [c.launches for c in counters]
            m = task.gan_step(batch)
            torch.cuda.synchronize()
            require(all(torch.isfinite(v).item() for v in m.values()),
                    f"HiFiGAN gan_step {dt_name}: non-finite {m}")
            t0 = time.perf_counter()
            for _ in range(2):
                task.gan_step(batch)
            torch.cuda.synchronize()
            step_rows[dt_name] = {
                "step_ms": (time.perf_counter() - t0) * 1e3 / 2,
                "launches a step": [c.launches - b
                                    for c, b in zip(counters, before)],
                "losses": {k: float(v) for k, v in m.items()}}
            del task
    finally:
        torch.backends.cudnn.deterministic = False
    launches = {c.__name__: c.launches for c in counters}
    require(all(n > 0 for n in launches.values()),
            f"a kernel was not launched in the HiFiGAN gan_steps: {launches}")
    say(f"HiFiGAN gan_step (B={TB} x 16000): {step_rows}; launches "
        f"{launches}")

    rows = []
    kgen = torch.Generator(device=dev).manual_seed(27)
    F = torch.nn.functional
    tgrad = torch.nn.grad
    B2 = 2 * TB
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        for what, T, cin, cout, K in HIFIGAN_SHAPES:
            x = torch.randn((B2, T, cin), generator=kgen, device=dev).to(dtype)
            g = torch.randn((B2, T, cout), generator=kgen, device=dev).to(
                dtype)
            w = (torch.randn((K, cin, cout), generator=kgen, device=dev)
                 / (K * cin) ** 0.5).to(dtype)
            b = (0.1 * torch.randn((cout,), generator=kgen,
                                   device=dev)).to(dtype)
            xt, gt = (v.transpose(1, 2).contiguous() for v in (x, g))
            wt = w.permute(2, 1, 0).contiguous()
            pad = (K - 1) // 2
            esize = x.element_size()
            ops = 2 * B2 * T * K * cin * cout
            shape = f"({B2},{T},{cin})->{cout} K={K}"
            fwd_bytes = (x.numel() + w.numel() + b.numel()
                         + B2 * T * cout) * esize
            dx_bytes = (g.numel() + w.numel() + x.numel()) * esize
            wg_bytes = (x.numel() + g.numel()) * esize + (w.numel() + cout) * 4
            for (name, src, line, nbytes, fn, plain, lib, lib_name,
                 variant) in (
                ("window_conv", "window_conv.cu", 155, fwd_bytes,
                 lambda: window_conv(x, w, b, 1, None),
                 lambda: window_conv_plain(x, w, b, 1, None),
                 lambda: F.conv1d(xt, wt, b, padding=pad),
                 "F.conv1d", fwd_plan(dtype, B2, T, cin, cout)["variant"]),
                ("window_conv_dx", "window_conv_grad.cu", 252, dx_bytes,
                 lambda: window_conv_dx(g, w, 1),
                 lambda: window_conv_dx_plain(g, w, 1),
                 lambda: tgrad.conv1d_input(xt.shape, wt, gt, padding=pad),
                 "torch.nn.grad.conv1d_input",
                 fwd_plan(dtype, B2, T, cout, cin)["variant"]),
                ("window_conv_wgrad", "window_conv_grad.cu", 203, wg_bytes,
                 lambda: window_conv_wgrad(x, g, K, 1, None),
                 lambda: window_conv_wgrad_plain(x, g, K, 1, None),
                 lambda: tgrad.conv1d_weight(xt, wt.shape, gt, padding=pad),
                 "torch.nn.grad.conv1d_weight",
                 wgrad_plan(dtype, B2, T, K, cin, cout)["variant"]),
            ):
                got, want = fn(), plain()
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                torch.cuda.synchronize()
                err = 0.0
                for a, c in zip(got, want):
                    e = (a.float() - c.float()).abs().max().item()
                    scale = c.float().abs().max().item()
                    require(torch.isfinite(a).all().item(),
                            f"{name} {dt} {what}: non-finite")
                    require(e <= TOL_CONV[dtype] * scale,
                            f"{name} {dt} {what}: max err {e} > "
                            f"{TOL_CONV[dtype]} x {scale}")
                    err = max(err, e)
                b_ms, b_by = bound(nbytes, ops, dtype)
                row = {
                    "name": f"{name} {dt} {what} {shape}",
                    "route": "cuda",
                    "source": f"svcc23_fastsvc_tpu_torch/csrc/{src}",
                    "replaces": f"svcc23_fastsvc_tpu/ops/"
                                f"pallas_window_conv.py:{line}",
                    "launches": launches[name],
                    "max_abs_err": err,
                    "ms": cuda_ms(fn, iters=10),
                    "plain_ms": cuda_ms(plain, iters=3, warmup=1),
                    "bound_ms": b_ms,
                    "bound_by": b_by,
                    "library_ms": cuda_ms(lib, iters=10),
                    "library": lib_name,
                    "variant": variant,
                    "device_ms": queued_ms(fn, iters=10),
                    "library_device_ms": queued_ms(lib, iters=10),
                }
                rows.append(row)
                say(f"{row['name']}: max err {err:.3e}; {row['ms']:.4f} ms "
                    f"(plain {row['plain_ms']:.4f}, library "
                    f"{row['library_ms']:.4f}, bound {b_ms:.4f} by {b_by}); "
                    f"{variant}, device {row['device_ms']:.4f} ms, library "
                    f"device {row['library_device_ms']:.4f} ms")
            del x, g, w, b, xt, gt, wt
    return rows, launches, held


# phase 28: Trainer.run with the warm-up fast-forward, dumps and a profile
OPTIONS_CONFIG = {**TRAIN_CONFIG,
                  "generator_train_start_steps": 4,
                  "discriminator_train_start_steps": 4,
                  "train_max_steps": 7, "log_interval_steps": 1,
                  "eval_interval_steps": 7, "save_interval_steps": 100000,
                  "eval_batches": 1, "num_save_intermediate_results": 2,
                  "steps_per_call": 1}


def trainer_options_phase(dev, items, counters):
    """Phase 28: `Trainer.run` at full width, bf16 (packed wire) and f32,
    with generator_train_start_steps 4 (the count jumps to 5 and two
    gan_steps run), an eval and two intermediate dumps at step 7, and a
    `profile_dir`: the calls, the step count and the optimizers' counts
    (which do not jump), the checkpoint at step 7, the dump wavs (their
    generated half that of the task's `predict`, finite) and pngs where
    matplotlib is installed, and a trace file with kernel records."""
    from scipy.io import wavfile

    from svcc23_fastsvc_tpu_torch.bin.common import write_wav
    from svcc23_fastsvc_tpu_torch.config import build_train_task
    from svcc23_fastsvc_tpu_torch.data.collate import FastSVCBatcher
    from svcc23_fastsvc_tpu_torch.data.wire import to_device
    from svcc23_fastsvc_tpu_torch.train.loop import Trainer

    from svcc23_fastsvc_tpu_torch.bin.common import deterministic_cudnn

    for c in counters:
        c.launches = 0
    out = {}
    workdir = tempfile.mkdtemp(prefix="chip_smoke_options_")
    deterministic_cudnn()  # as the training CLI runs
    try:
        for dt_name, wire in (("bfloat16", "packed"), ("float32", "f32")):
            outdir = os.path.join(workdir, dt_name)
            cfg = {**OPTIONS_CONFIG, "compute_dtype": dt_name,
                   "wire_format": wire,
                   "profile_dir": os.path.join(outdir, "profile")}
            task = build_train_task(cfg, device=dev, seed=7)

            def dev_batcher():
                return FastSVCBatcher(items, batch_size=TB,
                                      batch_length=16000, hop_size=HOP,
                                      seed=9)
            trainer = Trainer(
                task, FastSVCBatcher(items, batch_size=TB, batch_length=16000,
                                     hop_size=HOP, seed=1),
                config=cfg, outdir=outdir, dev_batcher=dev_batcher())
            t0 = time.perf_counter()
            trainer.run()
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            require(trainer.call_sizes == [1, 1] and task.step == 7
                    and (task.g_opt.count, task.d_opt.count) == (2, 2)
                    and [h["step"] for h in trainer.history] == [6, 7]
                    and all("discriminator_loss" in h
                            for h in trainer.history),
                    f"options {dt_name}: calls {trainer.call_sizes}, step "
                    f"{task.step}, counts {task.g_opt.count} "
                    f"{task.d_opt.count}, history {trainer.history}")
            require(os.path.exists(os.path.join(
                outdir, "checkpoint-7steps.pkl")), "no checkpoint at 7")
            pred = os.path.join(outdir, "predictions", "step7")
            files = sorted(os.listdir(pred)) if os.path.isdir(pred) else []
            wavs = ["0_gen.wav", "0_ref.wav", "1_gen.wav", "1_ref.wav"]
            require(set(wavs) <= set(files), f"dumps {dt_name}: {files}")
            dev_b = dev_batcher()
            dev_b.sample_batch()  # the eval's batch; the dump takes the next
            y = task.predict(to_device(dev_b.sample_batch(), dev), seed=7)
            require(torch.isfinite(y).all().item(),
                    f"dump forward {dt_name}: non-finite")
            lsb = []  # PCM16 steps between each dump and the forward's
            for i in range(2):
                tmp = os.path.join(workdir, "want.wav")
                write_wav(tmp, y[i, :, 0].cpu().numpy(), SR)
                lsb.append(int(np.abs(
                    wavfile.read(os.path.join(pred, f"{i}_gen.wav"))[1]
                    .astype(np.int64) - wavfile.read(tmp)[1]).max()))
            require(max(lsb) <= 1, f"dumps {dt_name}: generated wavs "
                                   f"{lsb} PCM steps from the forward's")
            # named by the run's first step, after the fast-forward
            trace = os.path.join(outdir, "profile", "trace-step5.json")
            require(os.path.exists(trace), f"no trace file at {trace}")
            with open(trace) as f:
                events = json.load(f)["traceEvents"]
            kernels = sum(e.get("cat") == "kernel" for e in events)
            require(kernels > 0, f"trace {dt_name}: no kernel records")
            out[dt_name] = {
                "run_s (profiled)": run_s, "calls": trainer.call_sizes,
                "dump vs predict, max PCM steps": lsb,
                "pngs": [f for f in files if f.endswith(".png")],
                "trace_mib": os.path.getsize(trace) / 2 ** 20,
                "trace kernel records": kernels,
                "losses at 7": {k: v for k, v in trainer.history[-1].items()
                                if k.endswith("_loss")}}
            say(f"trainer options {dt_name} ({wire} wire): {out[dt_name]}")
            del task, trainer
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(workdir, ignore_errors=True)
    launches = {c.__name__: c.launches for c in counters}
    require(all(n > 0 for n in launches.values()),
            f"a kernel was not launched in the options run: {launches}")
    say(f"trainer options main path: launches {launches}")
    return launches


# phase 29: both recipe drivers from wavs to converted wavs through the
# port's CLIs on the card, every CLI a process of its own; phase 23's
# voices, two speakers, train and dev utterances of 2-4 s; the recipe
# yamls as they are but for the schedule (RECIPE_CUTS)
# (6 train utterances until phase 30 was added: this cut helps pay for it)
RECIPE_SPLITS = (("train", 4), ("dev", 2))
RECIPE_CUTS = {
    # K = 8 (steps_per_call): one 8-step gen call, one 8-step gan call
    "fastsvc1": {"discriminator_train_start_steps": 8,
                 "train_max_steps": 16, "save_interval_steps": 16},
    # one step a call: two gen_steps, two gan_steps
    "baseline02": {"discriminator_train_start_steps": 2,
                   "train_max_steps": 4, "save_interval_steps": 4},
}
RECIPE_CONF = {"fastsvc1": ("fastsvc1", "fastsvc.yaml", SR),
               "baseline02": ("baseline02", "taco2.yaml", VSR)}
RECIPE_TRG = "spkB"
RECIPE_DEVICE = "cuda"
# the kernels each driver's stages must launch (the others may not run)
RECIPE_KERNELS = {
    "fastsvc1": {"4": ("sine_excitation", "window_conv", "window_conv_dx",
                       "window_conv_wgrad"),
                 "5": ("sine_excitation", "window_conv")},
    "baseline02": {"4": ("window_conv", "window_conv_dx",
                         "window_conv_wgrad"),
                   "5": ("window_conv",),
                   "7": ("pd_fixed_block", "pd_adaptive_block")},
}
RECIPE_TIMEOUT_S = 400


def recipe_driver_log(text, counted):
    """(stage -> {"s", "processes", "launches"}) from a driver's output:
    its `stage N: ...` lines, its final `stages {json}` line, and the
    `kernel launches: {json}` lines its CLIs log, each counted to the stage
    that reports after it; each of those must count every wrapper named in
    `counted`."""
    report, pending = {}, []
    for line in text.splitlines():
        if "kernel launches: " in line:
            pending.append(json.loads(line.split("kernel launches: ", 1)[1]))
            require(set(pending[-1]) == counted,
                    f"a CLI logged the launches of {sorted(pending[-1])}, "
                    f"not of every counted wrapper {sorted(counted)}")
        elif line.startswith("stage ") and ": " in line:
            n = line.split(":", 1)[0].split(" ", 1)[1]
            launches = {}
            for counts in pending:
                for k, v in counts.items():
                    launches[k] = launches.get(k, 0) + v
            report[n] = {"launches": launches}
            pending = []
        elif line.startswith("stages {"):
            for n, row in json.loads(line.split(" ", 1)[1]).items():
                report.setdefault(n, {"launches": {}}).update(row)
    return report


def recipe_drivers_phase(dev, phases, keep_dir):
    """Phase 29: `python -m svcc23_fastsvc_tpu_torch.recipes.fastsvc1`
    (stages 0-5) and `.baseline02` (stages 0-5 and 7), at once, each a
    process of its own that runs every stage as CLI processes on the card
    (`--device cuda`): stage 0 in `--mode hash` (no x-vector weights
    in the repository), stage 1 at `--n-jobs 2` through the local launcher,
    FastSVC's linguistic features from a seeded conformer PPG and B02's
    from a seeded HuBERT-soft (reference layouts), each recipe yaml as it
    is (full width; FastSVC bf16, K = 8, `loader_threads: 4`) but for the
    schedule (RECIPE_CUTS), stage 7 through a seeded HN-uSFGAN `.pkl`.
    Each stage's seconds, processes and, from the CLIs' logs, kernel
    launches; every converted wav's length and finiteness; FastSVC stage
    5's wavs against an in-process `decode` (its `synthesize`) of the same
    checkpoint on the same dumps: equal PCM bit for bit, else within phase
    4's bf16 bound. The FastSVC driver's normalized train dumps and its
    yaml are copied to `keep_dir` for phase 30."""
    import signal

    import yaml
    from scipy.io import wavfile

    from svcc23_fastsvc_tpu_torch.bin.common import read_wav, write_wav
    from svcc23_fastsvc_tpu_torch.bin.decode_fastsvc import decode
    from svcc23_fastsvc_tpu_torch.config import build_vocoder
    from svcc23_fastsvc_tpu_torch.models.conformer_ppg import ConformerPPG
    from svcc23_fastsvc_tpu_torch.models.hubert import (
        HubertSoft,
        bshall_checkpoint,
    )
    from svcc23_fastsvc_tpu_torch.train.checkpoint import (
        latest_checkpoint,
        save_generator_checkpoint,
    )

    from svcc23_fastsvc_tpu_torch.ops import counted_kernels

    counted = {k.__name__ for k in counted_kernels()}
    require(all(set(names) <= counted for stages in RECIPE_KERNELS.values()
                for names in stages.values()),
            f"RECIPE_KERNELS names a wrapper that counts no launches: "
            f"{RECIPE_KERNELS}")
    top = tempfile.mkdtemp(prefix="chip_smoke_recipes_")
    out, runs = {}, {}
    try:
        # the seeded models, in the layouts the CLIs read
        ppg_path = os.path.join(top, "24epoch.pth")
        torch.save(reference_layout_weights(ConformerPPG, 10), ppg_path)
        hubert_path = os.path.join(top, "hubert-soft-0d54a1f4.pt")
        torch.save(bshall_checkpoint(HubertSoft(), seed=24), hubert_path)
        voc_dir = os.path.join(top, "voc")
        voc_cfg = {**VOC_CONFIG, "generator_params": {
            **VOC_CONFIG["generator_params"], "aux_channels": 63}}
        torch.manual_seed(15)
        save_generator_checkpoint(
            os.path.join(voc_dir, "checkpoint-100steps.pkl"),
            build_vocoder(voc_cfg), 100)
        with open(os.path.join(voc_dir, "config.yml"), "w") as f:
            yaml.safe_dump(voc_cfg, f)
        env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", "")}
        logs, walls, texts = {}, {}, {}

        for recipe, (egs, yml, sr) in RECIPE_CONF.items():
            root = os.path.join(top, recipe)
            for split, n in RECIPE_SPLITS:
                d = os.path.join(root, "data", split)
                os.makedirs(d)
                with open(os.path.join(d, "wav.scp"), "w") as f:
                    for i in range(n):
                        utt = f"spk{'AB'[i % 2]}_{split}{i}"
                        path = os.path.join(root, "wav", f"{utt}.wav")
                        os.makedirs(os.path.dirname(path), exist_ok=True)
                        write_wav(path, fe_singing(
                            130.0 + 25 * (i + 4 * (split == "dev")), sr, i,
                            seconds=2.0 + i % 3), sr)
                        f.write(f"{utt} {path}\n")
            with open(os.path.join(ROOT, "egs", "svcc23", egs, "conf",
                                   yml)) as f:
                cfg = yaml.safe_load(f)
            cfg.update(RECIPE_CUTS[recipe])
            with open(os.path.join(root, "conf.yaml"), "w") as f:
                yaml.safe_dump(cfg, f)
            argv = ["--conf", "conf.yaml", "--n-jobs", "2", "--speakers",
                    RECIPE_TRG, "--device", RECIPE_DEVICE]
            if recipe == "fastsvc1":
                argv += ["--linguistic", "conformer", "--ppg-checkpoint",
                         ppg_path]
            else:
                with open(os.path.join(root, "f0_stats.yml"), "w") as f:
                    yaml.safe_dump({s: {"lf0_mean": float(np.log(f0)),
                                        "lf0_scale": 0.1}
                                    for s, f0 in (("spkA", 150.0),
                                                  ("spkB", 240.0))}, f)
                argv += ["--linguistic", "hubert", "--hubert-checkpoint",
                         hubert_path, "--f0-stats", "f0_stats.yml",
                         "--vocoder-dir", voc_dir]
            logs[recipe] = os.path.join(root, "driver.log")
            with open(logs[recipe], "w") as log:
                runs[recipe] = subprocess.Popen(
                    [sys.executable, "-m",
                     f"svcc23_fastsvc_tpu_torch.recipes.{recipe}", *argv],
                    cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT,
                    start_new_session=True)  # its CLIs in its group
        t = time.perf_counter()
        for recipe, proc in runs.items():
            try:
                rc = proc.wait(timeout=max(
                    1.0, RECIPE_TIMEOUT_S - (time.perf_counter() - t)))
            except subprocess.TimeoutExpired:
                rc = "timed out"
            walls[recipe] = time.perf_counter() - t
            with open(logs[recipe]) as f:
                texts[recipe] = f.read()
            require(rc == 0, f"{recipe} driver: rc {rc}\n"
                    f"{texts[recipe][-6000:]}")

        for recipe in RECIPE_CONF:
            root = os.path.join(top, recipe)
            report = recipe_driver_log(texts[recipe], counted)
            want = ["0", "1", "2", "3", "4", "5"] + (
                ["7"] if recipe == "baseline02" else [])
            require(sorted(report) == want and all(
                "s" in r for r in report.values()),
                f"{recipe}: stages {sorted(report)}")
            require(report["1"]["processes"] == 4,
                    f"{recipe} stage 1: {report['1']}")
            for n, names in RECIPE_KERNELS[recipe].items():
                got = report[n]["launches"]
                require(all(got.get(k, 0) > 0 for k in names),
                        f"{recipe} stage {n}: a kernel of its path was not "
                        f"launched: {got}")
            for n, r in sorted(report.items()):
                say(f"{recipe} stage {n}: {r['s']:.3f} s, {r['processes']} "
                    f"processes, launches "
                    f"{ {k: v for k, v in r['launches'].items() if v} }")
            tag = os.path.join(root, "exp", "fastsvc" if recipe ==
                               "fastsvc1" else "taco2")
            wavs = {}
            for name in sorted(os.listdir(os.path.join(tag, "wav"))):
                audio, wsr = read_wav(os.path.join(tag, "wav", name))
                wavs[name] = {"samples": len(audio), "sr": wsr,
                              "finite": bool(np.isfinite(audio).all())}
            require(len(wavs) == 2 and all(
                w["finite"] and w["samples"] >= w["sr"]
                for w in wavs.values()),
                f"{recipe}: converted wavs {wavs}")
            say(f"{recipe} converted wavs: {wavs}")
            out[recipe] = {"wall_s": walls[recipe], "stages": report,
                           "wavs": wavs}
            phases[f"recipe_{recipe}_s"] = walls[recipe]

        # FastSVC stage 5 against an in-process decode of its checkpoint
        root = os.path.join(top, "fastsvc1")
        exp = os.path.join(root, "exp", "fastsvc")
        mine = os.path.join(top, "in_process")
        decode(os.path.join(root, "dump", "dev_norm"),
               latest_checkpoint(exp), mine,
               f0_stats_dir=os.path.join(root, "dump", "f0_stats"),
               spk_emb_file=os.path.join(root, "dump", "spk_embs.h5"),
               convert_to_speakers=[RECIPE_TRG], device=dev)
        held = {}
        for name in sorted(os.listdir(os.path.join(exp, "wav"))):
            a = wavfile.read(os.path.join(exp, "wav", name))[1]
            b = wavfile.read(os.path.join(mine, name))[1]
            require(a.shape == b.shape, f"{name}: {a.shape} vs {b.shape}")
            diff = int(np.abs(a.astype(np.int64) - b).max())
            scale = max(int(np.abs(b.astype(np.int64)).max()), 1)
            held[name] = ("bit for bit" if diff == 0 else
                          f"within {diff / scale:.3g} of max |y|")
            require(diff <= TOL_DECODE[torch.bfloat16] * scale,
                    f"{name}: stage 5 {diff} PCM steps from the in-process "
                    f"decode (max |y| {scale})")
        say(f"fastsvc1 stage 5 vs in-process decode: {held}")
        out["stage5_vs_in_process"] = held
        shutil.copytree(os.path.join(root, "dump", "train_norm"),
                        os.path.join(keep_dir, "train_norm"))
        shutil.copy(os.path.join(root, "conf.yaml"), keep_dir)
    finally:
        for proc in runs.values():  # what a failure left running: a
            try:                    # driver and the CLIs it started
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
        shutil.rmtree(top, ignore_errors=True)
    return out

# phase 30: data parallelism on the one card. (a) two ranks share it over
# gloo (NCCL refuses two ranks on one device), one gen_step and one
# gan_step each from the seed's weights, at the recipe's width and batch
# (TRAIN_CONFIG, 32 x 16000 split 16 + 16), f32, the excitation fed;
# (b) one NCCL rank at the recipe's bf16 and K = 8, its all-reduces
# captured in the graphs; (c) the training CLI as two gloo ranks on phase
# 29's dumps. N NCCL ranks on N cards wait for a machine with several.
DP_RANKS = 2
DP_TIMEOUT_S = 300
TOL_DP_LOSS = 1e-4  # metrics, relative: the halves' sums in another order
# each model's update, relative L2, against one process that runs the
# generator on the ranks' row blocks one after another: the log-magnitude
# term's gradient amplifies f32 round-off (ROADMAP: f32 gradients a median
# 1.1% from f64), and the weight gradients summed over 16-row blocks
# round otherwise than over 32 rows, which moved one process's gen_step G
# update by 4.8e-3 on the H100; the distance from the plain
# one-process step is reported beside it
TOL_DP_UPDATE = 1e-3
DP_CLI_STEPS = 2  # one gen_step, one gan_step a rank


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _flat_params(task):
    return {who: torch.cat([p.detach().reshape(-1).double().cpu()
                            for p in m.parameters()])
            for who, m in (("G", task.generator),
                           ("D", task.discriminator))}


class BlocksGenerator(torch.nn.Module):
    """The generator run on the ranks' row blocks one after another, the
    outputs concatenated: one process's step that computes what the ranks
    compute, block by block (a 30(a) reference). Its parameters are the
    wrapped generator's."""

    def __init__(self, generator, parts):
        super().__init__()
        self.inner, self.parts = generator, parts

    def forward(self, *args, **kwargs):
        rows = args[0].shape[0] // self.parts
        return torch.cat([self.inner(*(
            None if a is None else a[i * rows:(i + 1) * rows]
            for a in args), **kwargs) for i in range(self.parts)])


def dp_step_run(dev, batch, phase, mesh=None, blocks=None):
    """One `phase` step of TRAIN_CONFIG (f32) from the seed's weights on
    `batch` (host arrays, excitation included), on this rank's rows when
    `mesh` is a data group, the generator run on `blocks` row blocks when
    given: (metrics, G and D updates as f64 vectors, task)."""
    from svcc23_fastsvc_tpu_torch.config import build_train_task
    from svcc23_fastsvc_tpu_torch.parallel import (
        shard_batch,
        shard_map_step_dp,
    )

    task = build_train_task(TRAIN_CONFIG, device=dev, seed=3)
    if blocks is not None:
        task.generator = BlocksGenerator(task.generator, blocks)
    before = _flat_params(task)
    step = (getattr(task, f"{phase}_step") if mesh is None
            else shard_map_step_dp(task, phase, mesh))
    metrics = step(shard_batch(batch, mesh, device=dev))
    torch.cuda.synchronize()
    after = _flat_params(task)
    return ({k: float(v) for k, v in metrics.items()},
            {who: after[who] - before[who] for who in after}, task)


def dp_rank_main(rank, port, workdir):
    """`python3 chip_smoke.py --dp-rank R PORT DIR`: rank R of phase
    30(a), over gloo on the card: its gen_step and gan_step on its rows of
    DIR/batch.pt; metrics, launches and the replicas' checksum (and on rank
    0 the updates) to DIR/rank{R}.pt, with a second, warm step of each
    phase timed and one all-reduce of each model's gradient size timed
    alone."""
    sys.path.insert(0, ROOT)
    from svcc23_fastsvc_tpu_torch.bin.common import (
        deterministic_cudnn,
        disable_tf32,
    )
    from svcc23_fastsvc_tpu_torch.ops import counted_kernels
    from svcc23_fastsvc_tpu_torch.parallel import (
        initialize,
        make_mesh,
        shard_batch,
    )
    from svcc23_fastsvc_tpu_torch.parallel.distributed import (
        replica_checksum,
    )
    from svcc23_fastsvc_tpu_torch.parallel.mesh import pmean

    disable_tf32()
    deterministic_cudnn()
    dev = initialize(f"127.0.0.1:{port}", DP_RANKS, rank, device="cuda")
    mesh = make_mesh()
    batch = torch.load(os.path.join(workdir, "batch.pt"), weights_only=False)
    out = {"metrics": {}, "launches": {}, "checksum": {}, "update": {},
           "step_ms": {}, "all_reduce_ms": {}}
    for phase in ("gen", "gan"):
        for c in counted_kernels():
            c.launches = 0
        metrics, update, task = dp_step_run(dev, batch, phase, mesh)
        out["launches"][phase] = {c.__name__: c.launches
                                  for c in counted_kernels() if c.launches}
        out["metrics"][phase] = metrics
        out["checksum"][phase] = replica_checksum(task.generator,
                                                  task.discriminator)
        if rank == 0:
            out["update"][phase] = {k: v.float() for k, v in update.items()}
        # a second step of the phase on the same rows, warm, timed
        step = getattr(task, f"{phase}_step")
        local = shard_batch(batch, mesh, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(local)
        torch.cuda.synchronize()
        out["step_ms"][phase] = (time.perf_counter() - t) * 1e3
        del task
    # the gradient all-reduce alone: one flat f32 buffer of each model's
    # size on the card, as `pmean` sends it, median of 5 after 2 warm
    for who, n in (("G", update["G"].numel()), ("D", update["D"].numel())):
        flat = torch.ones(n, device=dev)
        times = []
        for i in range(7):
            torch.cuda.synchronize()
            t = time.perf_counter()
            pmean([flat], mesh)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        out["all_reduce_ms"][who] = statistics.median(times[2:])
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def _wait_all(procs, what, logs=None):
    """Wait for every process (DP_TIMEOUT_S in all); kill what is left and
    raise with the failing one's log tail."""
    t = time.perf_counter()
    rcs = []
    try:
        for p in procs:
            try:
                rcs.append(p.wait(timeout=max(
                    1.0, DP_TIMEOUT_S - (time.perf_counter() - t))))
            except subprocess.TimeoutExpired:
                rcs.append("timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, rc in enumerate(rcs):
        tail = ""
        if logs is not None:
            with open(logs[i]) as f:
                tail = f.read()[-4000:]
        require(rc == 0, f"{what} {i}: rc {rc}\n{tail}")
    return time.perf_counter() - t


def dp_phase(dev, items, keep_dir, counters, loader_rate):
    """Phase 30: (a), then (c), as processes, then (b) in this
    process (see the constants above; `loader_rate` is phase 25's timed
    interval at K = 8). Returns the launches of the counted kernels by
    path and rank."""
    import yaml

    from svcc23_fastsvc_tpu_torch.bin.common import deterministic_cudnn
    from svcc23_fastsvc_tpu_torch.config import (
        build_signal_generator,
        load_config,
    )
    from svcc23_fastsvc_tpu_torch.data.collate import FastSVCBatcher
    from svcc23_fastsvc_tpu_torch.data.wire import to_device

    deterministic_cudnn()  # as the training CLI sets it
    paths = {}
    workdir = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    procs = []
    try:
        # (a)'s global batch: the recipe's, with the excitation made here
        # (sine kernel and noise), so every rank and the reference get it
        batch = FastSVCBatcher(items, batch_size=TB, batch_length=16000,
                               hop_size=HOP, seed=3).sample_batch()
        sg = build_signal_generator(TRAIN_CONFIG)
        f0 = torch.as_tensor(batch["f0"]).to(dev)
        batch["sine"] = sg(f0, torch.Generator(device=dev).manual_seed(4)
                           ).cpu().numpy()
        torch.save(batch, os.path.join(workdir, "batch.pt"))
        env = {**os.environ, "SVC_DIST_BACKEND": "gloo",
               "PYTHONPATH": ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", "")}
        port = _free_port()
        logs = [os.path.join(workdir, f"rank{r}.log") for r in
                range(DP_RANKS)]
        t_a = time.perf_counter()
        for r in range(DP_RANKS):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--dp-rank",
                     str(r), str(port), workdir], env=env, stdout=log,
                    stderr=subprocess.STDOUT))
        # (a)'s references: one process on the global batch, its
        # generator run on the ranks' row blocks (held to) and as it is
        # (reported)
        ref, ref_ms, plain, plain_tasks = {}, {}, {}, {}
        for phase in ("gen", "gan"):
            *plain[phase], plain_tasks[phase] = dp_step_run(dev, batch,
                                                            phase)
            metrics, update, task = dp_step_run(dev, batch, phase,
                                                blocks=DP_RANKS)
            ref[phase] = (metrics, update)
            del task
        _wait_all(procs[:DP_RANKS], "DP rank", logs)
        # one process's warm step, timed once the ranks have left the card
        tbatch = to_device(batch, dev)
        for phase, task in plain_tasks.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            getattr(task, f"{phase}_step")(tbatch)
            torch.cuda.synchronize()
            ref_ms[phase] = (time.perf_counter() - t) * 1e3
        del plain_tasks, task
        ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                            weights_only=False) for r in range(DP_RANKS)]
        report = {}
        for phase in ("gen", "gan"):
            want_m, want_u = ref[phase]
            got_m = ranks[0]["metrics"][phase]
            require(all(r["metrics"][phase] == got_m for r in ranks)
                    and all(r["checksum"][phase] == ranks[0]["checksum"][
                        phase] for r in ranks),
                    f"DP {phase}: the ranks differ")
            rel = {k: abs(got_m[k] - v) / max(abs(v), 1e-12)
                   for k, v in want_m.items()}
            rel_plain = {k: abs(got_m[k] - v) / max(abs(v), 1e-12)
                         for k, v in plain[phase][0].items()}

            def l2(a, b):  # a gen_step leaves D as it is: 0 in both
                diff = (a.double() - b).norm()
                return (diff / b.norm()).item() if b.norm() else float(diff)

            got_u = ranks[0]["update"][phase]
            dist_l2 = {who: l2(got_u[who], want_u[who]) for who in want_u}
            report[phase] = {
                "max metric rel err": max(rel.values()),
                "update rel L2": dist_l2,
                "vs one process's plain loss: max metric rel err":
                    max(rel_plain.values()),
                "update rel L2 (plain)": {
                    who: l2(got_u[who], u)
                    for who, u in plain[phase][1].items()}}
            require(set(got_m) == set(want_m)
                    and max(max(rel.values()), max(rel_plain.values()))
                    <= TOL_DP_LOSS,
                    f"DP {phase}: metrics {got_m} vs one process {want_m}")
            require(all(d <= TOL_DP_UPDATE for d in dist_l2.values()),
                    f"DP {phase}: update distances {report[phase]}")
            for r, rk in enumerate(ranks):
                paths[f"dp_train_gloo_rank{r}"] = paths.get(
                    f"dp_train_gloo_rank{r}", {})
                for k, v in rk["launches"][phase].items():
                    paths[f"dp_train_gloo_rank{r}"][k] = paths[
                        f"dp_train_gloo_rank{r}"].get(k, 0) + v
        trained = ("window_conv", "window_conv_dx", "window_conv_wgrad")
        require(all(paths[f"dp_train_gloo_rank{r}"].get(k, 0) > 0
                    for r in range(DP_RANKS) for k in trained),
                f"DP (a): a kernel of the step was not launched on a rank: "
                f"{paths}")
        say(f"DP (a) 2 gloo ranks on the card vs one process (B={TB} x "
            f"16000, f32, each step from the seed's weights, excitation "
            f"fed): {report}; the ranks' metrics and checksums equal; "
            f"launches by rank "
            f"{[paths[f'dp_train_gloo_rank{r}'] for r in range(DP_RANKS)]}; "
            f"warm step ms by rank "
            f"{[rk['step_ms'] for rk in ranks]} (one process {ref_ms}); "
            f"one gloo all-reduce of G's / D's gradient size by rank "
            f"{[rk['all_reduce_ms'] for rk in ranks]} ms; "
            f"(a) wall {time.perf_counter() - t_a:.1f} s")

        # (c): the CLI, two gloo ranks, the recipe yaml at K = 1, 2 steps
        cfg = load_config(os.path.join(keep_dir, "conf.yaml"))
        cfg.update(steps_per_call=1, discriminator_train_start_steps=1,
                   train_max_steps=DP_CLI_STEPS,
                   save_interval_steps=DP_CLI_STEPS,
                   log_interval_steps=DP_CLI_STEPS)
        cli_yaml = os.path.join(workdir, "cli.yaml")
        with open(cli_yaml, "w") as f:
            yaml.safe_dump(cfg, f)
        cli_out = os.path.join(workdir, "exp")
        cli_logs = [os.path.join(workdir, f"cli{r}.log")
                    for r in range(DP_RANKS)]
        coordinator = f"127.0.0.1:{_free_port()}"
        t_c = time.perf_counter()
        cli = []
        for r in range(DP_RANKS):
            with open(cli_logs[r], "w") as log:
                cli.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "svcc23_fastsvc_tpu_torch.bin.train_fastsvc",
                     "--train-dumpdir", os.path.join(keep_dir, "train_norm"),
                     "--outdir", cli_out, "--config", cli_yaml,
                     "--n-procs", str(DP_RANKS), "--proc-id", str(r),
                     "--coordinator", coordinator], env=env, stdout=log,
                    stderr=subprocess.STDOUT))
        procs += cli
        _wait_all(cli, "DP CLI rank", cli_logs)
        sums, cli_launches = [], []
        for r, path in enumerate(cli_logs):
            with open(path) as f:
                text = f.read()
            require("data-parallel over 2 devices (2 processes)" in text,
                    f"CLI rank {r}: no data-parallel line")
            sums += [ln.split("parameter checksum: ", 1)[1].strip()
                     for ln in text.splitlines()
                     if "parameter checksum: " in ln]
            counts = [json.loads(ln.split("kernel launches: ", 1)[1])
                      for ln in text.splitlines() if "kernel launches: " in ln]
            require(len(counts) == 1, f"CLI rank {r}: launch lines {counts}")
            cli_launches.append({k: v for k, v in counts[0].items() if v})
            paths[f"dp_cli_rank{r}"] = counts[0]
        require(len(sums) == DP_RANKS and len(set(sums)) == 1,
                f"CLI ranks' parameter checksums {sums}")
        require(all(paths[f"dp_cli_rank{r}"].get(k, 0) > 0
                    for r in range(DP_RANKS)
                    for k in ("sine_excitation", *trained)),
                f"DP (c): a kernel of the step was not launched on a rank: "
                f"{cli_launches}")
        ckpt = os.path.join(cli_out, f"checkpoint-{DP_CLI_STEPS}steps.pkl")
        require(os.path.exists(ckpt), f"CLI: no {ckpt}")
        say(f"DP (c) train_fastsvc --n-procs 2 (gloo, one card, the recipe "
            f"yaml at K = 1, {DP_CLI_STEPS} steps): both rc 0, checksums "
            f"equal ({sums[0][:16]}), rank 0's checkpoint written, launches "
            f"by rank {cli_launches}, wall {time.perf_counter() - t_c:.1f} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(workdir, ignore_errors=True)
        shutil.rmtree(keep_dir, ignore_errors=True)

    # (b) one NCCL rank, K = 8 captured, against the same calls without a
    # data group: an all-reduce over one rank is the identity
    try:
        paths["dp_train_k8_nccl"] = dp_nccl_k_steps(dev, items, counters,
                                                    loader_rate)
    finally:
        torch.backends.cudnn.deterministic = False
    return paths


def dp_nccl_k_steps(dev, items, counters, loader_rate):
    from svcc23_fastsvc_tpu_torch.config import build_train_task, load_config
    from svcc23_fastsvc_tpu_torch.data.collate import FastSVCBatcher
    from svcc23_fastsvc_tpu_torch.data.wire import WirePacker
    from svcc23_fastsvc_tpu_torch.parallel import make_mesh, shard_map_step_dp
    from svcc23_fastsvc_tpu_torch.train.graphs import StepGraphs
    from svcc23_fastsvc_tpu_torch.train.loop import _stack

    dist = torch.distributed
    dist.init_process_group("nccl",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0, device_id=torch.device(
                                "cuda", torch.cuda.current_device()))
    try:
        recipe = load_config(os.path.join(ROOT, RECIPE_YAML))
        require(recipe["compute_dtype"] == "bfloat16"
                and recipe["steps_per_call"] == KSTEPS,
                f"{RECIPE_YAML}: not bf16 at K = {KSTEPS}")
        cfg = {**recipe, **LOADER_SCHEDULE}
        plain = build_train_task(cfg, device=dev, seed=7)
        dp = build_train_task(cfg, device=dev, seed=7)
        shard_map_step_dp(dp, "gen", make_mesh())  # dp.dp_group: 1 rank
        g_plain, g_dp = StepGraphs(plain), StepGraphs(dp)
        batcher = FastSVCBatcher(items, batch_size=recipe["batch_size"],
                                 batch_length=recipe["batch_length"],
                                 hop_size=HOP, seed=5)
        pack = WirePacker(hop_size=HOP)
        host = [pack(_stack([batcher.sample_batch() for _ in range(KSTEPS)]))
                for _ in range(2)]
        report = {}
        launches = dict.fromkeys((c.__name__ for c in counters), 0)
        for i, phase in enumerate(("gen", "gan")):
            want = g_plain.replay(g_plain.stage(phase, host[i]))
            for c in counters:  # the data-parallel calls' launches only
                c.launches = 0
            t0 = time.perf_counter()
            got = g_dp.replay(g_dp.stage(phase, host[i]))
            torch.cuda.synchronize()
            for c in counters:
                launches[c.__name__] += c.launches
            report[f"{phase} capture and replay s"] = (time.perf_counter()
                                                       - t0)
            report[f"{phase} metrics that differ"] = sum(
                not torch.equal(v, want[n]) for n, v in got.items())
            report[f"{phase} state that differs"] = _differing(plain, dp)
        require(all(report[f"{p} metrics that differ"] == 0
                    and not any(report[f"{p} state that differs"].values())
                    for p in ("gen", "gan")),
                f"NCCL K = {KSTEPS} calls differ from the calls without a "
                f"data group: {report}")
        require(all(n > 0 for n in launches.values()),
                f"a kernel was not launched on the NCCL K-step path: "
                f"{launches}")
        # the gan call's replay, turns plain, dp, dp, plain
        gan = {name: next(g for key, g in graphs_of.graphs.items()
                          if key[0] == "gan")
               for name, graphs_of in (("plain", g_plain), ("dp", g_dp))}
        times = {"plain": [], "dp": []}
        for name in ("plain", "dp", "dp", "plain"):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            gan[name].graph.replay()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
        say(f"DP (b) one NCCL rank, bf16 K = {KSTEPS} captured (all-reduces "
            f"in the graph) vs the same calls without a data group: "
            f"{report}; launches at capture {launches}; gan replay event "
            f"ms (turns plain, dp, dp, plain) {times}, "
            f"{statistics.mean(times['dp']) / KSTEPS:.3f} ms a step with "
            f"the data group, {statistics.mean(times['plain']) / KSTEPS:.3f}"
            f" without; phase 25's K = {KSTEPS} gan interval "
            f"{1e3 / loader_rate['steps_per_s']:.3f} ms a step (wall)")
        del plain, dp, g_plain, g_dp, gan
        torch.cuda.empty_cache()
        return launches
    finally:
        dist.destroy_process_group()


def main():
    # 1. device
    require(torch.cuda.is_available(), "no CUDA device: chip_smoke.py runs "
                                       "on an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    dev = torch.device("cuda")
    device_name = torch.cuda.get_device_name(0)
    say(f"device: {device_name}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    sys.path.insert(0, ROOT)
    from svcc23_fastsvc_tpu_torch.bin.decode_fastsvc import synthesize
    from svcc23_fastsvc_tpu_torch.config import (
        build_generator,
        build_signal_generator,
    )
    from svcc23_fastsvc_tpu_torch.ops import _build
    from svcc23_fastsvc_tpu_torch.ops.sine import (
        sine_excitation,
        sine_excitation_plain,
    )
    from svcc23_fastsvc_tpu_torch.ops.window_conv import (
        fwd_plan,
        wgrad_plan,
        window_conv,
        window_conv_dx,
        window_conv_dx_plain,
        window_conv_plain,
        window_conv_wgrad,
        window_conv_wgrad_plain,
    )

    phases = {}

    # 2. build
    t = time.perf_counter()
    _build.build()
    phases["build_s"] = time.perf_counter() - t
    ptxas = [ln.strip() for ln in _build.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    say(f"build: {phases['build_s']:.2f} s -> "
        f"{os.path.relpath(_build.library_path(), ROOT)}")
    for ln in ptxas:
        say(f"  ptxas {ln}")
    # the mma variants must run on the tensor cores: HMMA in their SASS
    hmma = sass_hmma_counts(_build.library_path(), _build._nvcc())
    if hmma is None:
        say("SASS HMMA check: not checked (no cuobjdump in the toolkit)")
    else:
        mma = {k: n for k, n in hmma.items() if "_mma_kernel" in k}
        for k, n in hmma.items():
            say(f"  SASS HMMA {n:4d}  {k[:120]}")
        family = {f: [n for k, n in mma.items() if f in k] for f in (
            "window_conv_mma", "wgrad_mma", "fused_bwd_mma", "pd_block_mma",
            "pd_chain_mma", "down_chain_mma")}
        require(all(family.values()) and all(n > 0 for n in mma.values()),
                f"mma instances without HMMA, or missing: {family}")
        say(f"SASS HMMA check: {len(mma)} mma instances, all with HMMA "
            f"({min(mma.values())}-{max(mma.values())} each): " + ", ".join(
                f"{f} {len(v)}" for f, v in family.items()))

    # 3. kernels against their plain versions
    t = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    conv_cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for what, T, cin, cout, dil, slope in CONV_SHAPES:
            x = torch.randn((B, T, cin), generator=gen, device=dev).to(dtype)
            w = (torch.randn((3, cin, cout), generator=gen, device=dev)
                 / (3 * cin) ** 0.5).to(dtype)
            b = (torch.randn((cout,), generator=gen, device=dev) * 0.1).to(dtype)
            y = window_conv(x, w, b, dil, slope)
            ref = window_conv_plain(x, w, b, dil, slope)
            err = (y.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            require(torch.isfinite(y).all().item(), f"window_conv {what}: non-finite")
            require(err <= TOL_CONV[dtype] * scale,
                    f"window_conv {what} {dtype}: max err {err} > "
                    f"{TOL_CONV[dtype]} x {scale}")
            conv_cases.append((dtype, what, T, cin, cout, dil, slope, x, w, b,
                               err))
            say(f"window_conv {str(dtype)[6:]} {what} ({B},{T},{cin})->{cout} "
                f"d={dil}: max err {err:.3e} (scale {scale:.3e})")
    grad_cases = []
    ggen = torch.Generator(device=dev).manual_seed(1)  # gen's stream as before
    for dtype in (torch.float32, torch.bfloat16):
        for what, T, cin, cout, dil, slope in GRAD_SHAPES:
            x = torch.randn((TB, T, cin), generator=ggen, device=dev).to(dtype)
            g = torch.randn((TB, T, cout), generator=ggen, device=dev).to(
                dtype)
            w = (torch.randn((3, cin, cout), generator=ggen, device=dev)
                 / (3 * cin) ** 0.5).to(dtype)
            dx = window_conv_dx(g, w, dil, x, slope)
            dw, db = window_conv_wgrad(x, g, 3, dil, slope)
            ref_dx = window_conv_dx_plain(g, w, dil, x, slope)
            ref_dw, ref_db = window_conv_wgrad_plain(x, g, 3, dil, slope)
            errs = {}
            for part, got, ref in (("dx", dx, ref_dx), ("dw", dw, ref_dw),
                                   ("db", db, ref_db)):
                err = (got.float() - ref.float()).abs().max().item()
                scale = ref.float().abs().max().item()
                require(torch.isfinite(got).all().item(),
                        f"window_conv {part} {what}: non-finite")
                require(err <= TOL_CONV[dtype] * scale,
                        f"window_conv {part} {what} {dtype}: max err {err} "
                        f"> {TOL_CONV[dtype]} x {scale}")
                errs[part] = (err, scale)
            dw2, db2 = window_conv_wgrad(x, g, 3, dil, slope)
            require(torch.equal(dw, dw2) and torch.equal(db, db2),
                    f"window_conv_wgrad {what} {dtype}: two calls differ")
            grad_cases.append((dtype, what, T, cin, cout, dil, slope, x, g, w,
                               errs))
            say(f"window_conv dx/wgrad {str(dtype)[6:]} {what} "
                f"({TB},{T},{cin})->{cout} d={dil}: " + ", ".join(
                    f"{n} max err {e:.3e} (scale {sc:.3e})"
                    for n, (e, sc) in errs.items()))
    f0 = random_f0(gen, dev, TF)
    f0_long = random_f0(gen, dev, TF_LONG)
    # the sine kernel: within TOL_SINE of its plain version, two calls bit
    # for bit, one kernel a call in the profile
    sgen = torch.Generator(device=dev).manual_seed(2)
    sine_cases = {}  # (B, Tf, hop, sr) -> (f0, max err)
    for b_, tf_, hop_, sr_ in SINE_SHAPES + SINE_EDGES:
        f = (f0 if (b_, tf_) == (B, TF) else f0_long
             if (b_, tf_) == (B, TF_LONG) else random_f0(sgen, dev, tf_, b_))
        s_k = sine_excitation(f, hop=hop_, sr=sr_, amp=0.1)
        s_k2 = sine_excitation(f, hop=hop_, sr=sr_, amp=0.1)
        s_p = sine_excitation_plain(f, hop=hop_, sr=sr_, amp=0.1)
        err = (s_k - s_p).abs().max().item()
        require(tuple(s_k.shape) == (b_, tf_ * hop_) and err <= TOL_SINE,
                f"sine_excitation {(b_, tf_, hop_, sr_)}: max err {err}")
        require(torch.equal(s_k, s_k2),
                f"sine_excitation {(b_, tf_, hop_, sr_)}: two calls differ")
        per_call = device_ms(
            lambda f=f, h=hop_, r=sr_: sine_excitation(f, hop=h, sr=r,
                                                      amp=0.1), n=3)
        require(len(per_call) == 1, f"sine_excitation {(b_, tf_, hop_, sr_)}:"
                                    f" kernels a call {list(per_call)}")
        sine_cases[(b_, tf_, hop_, sr_)] = (f, err)
        say(f"sine_excitation ({b_},{tf_}) hop {hop_} sr {sr_}: max err "
            f"{err:.3e}, two calls equal, kernels a call "
            f"{[k[:60] for k in per_call]}")
    phases["kernels_s"] = time.perf_counter() - t

    # 4. the slice end to end
    t = time.perf_counter()
    g32 = build_generator(CONFIG, device=dev, generator=gen)
    g32.fold_weight_norm_().eval()
    g16 = copy.deepcopy(g32).to(torch.bfloat16)
    sg = build_signal_generator(CONFIG)
    ppg = torch.randn((B, TF, 144), generator=gen, device=dev)
    lft = 0.1 * torch.randn((B, TF * HOP, 1), generator=gen, device=dev)
    emb = torch.randn((B, 512), generator=gen, device=dev)
    f0_in = f0[:, :, None]
    rng = torch.Generator(device=dev).manual_seed(1)

    counters = (window_conv, window_conv_dx, window_conv_wgrad,
                sine_excitation)
    for c in counters:
        c.launches = 0
    ys, rng_states = {}, {}
    for dtype, g in ((torch.float32, g32), (torch.bfloat16, g16)):
        rng_states[dtype] = rng.get_state()
        before = (window_conv.launches, sine_excitation.launches)
        ys[dtype] = synthesize(g, sg, ppg, f0_in, lft, emb, generator_rng=rng)
        torch.cuda.synchronize()
        rose = (window_conv.launches - before[0],
                sine_excitation.launches - before[1])
        require(rose == (60, 1), f"{dtype} batch launched {rose} "
                                 "(window_conv, sine); want (60, 1)")
    launches = {"window_conv": window_conv.launches,
                "sine_excitation": sine_excitation.launches}
    require(window_conv_dx.launches == window_conv_wgrad.launches == 0,
            "decode launched a backward kernel")
    say(f"decode main path: launches {launches}")
    for dtype, y in ys.items():
        require(tuple(y.shape) == (B, TF * HOP, 1), f"output shape {y.shape}")
        require(torch.isfinite(y).all().item(), f"{dtype} output not finite")

    decode_err = decode_vs_cpu(dev, {torch.float32: g32, torch.bfloat16: g16},
                               sg, (ppg, f0_in, lft, emb), rng_states, ys)
    say(f"decode vs the same module on the CPU: {decode_err}")
    phases["decode_s"] = time.perf_counter() - t

    # 5. timings
    t = time.perf_counter()
    audio_s = B * TF * HOP / SR
    decode_rate = {}
    for dtype, g in ((torch.float32, g32), (torch.bfloat16, g16)):
        ms = cuda_ms(lambda g=g: synthesize(g, sg, ppg, f0_in, lft, emb,
                                            generator_rng=rng),
                     iters=5, warmup=2)
        decode_rate[str(dtype)[6:]] = {"batch_ms": ms,
                                       "audio_s_per_s": audio_s / ms * 1e3}
    say(f"decode {B} x {TF * HOP / SR:.0f} s: {decode_rate}")

    kernels = []
    for dtype, what, T, cin, cout, dil, slope, x, w, b, err in conv_cases:
        esize = x.element_size()
        nbytes = (x.numel() + w.numel() + b.numel() + B * T * cout) * esize
        ops = 2 * B * T * 3 * cin * cout
        b_ms, b_by = bound(nbytes, ops, dtype)
        xt = (torch.nn.functional.leaky_relu(x, slope) if slope else x)
        xt = xt.transpose(1, 2).contiguous()
        wt = w.permute(2, 1, 0).contiguous()

        def kern():
            window_conv(x, w, b, dil, slope)

        def lib():
            torch.nn.functional.conv1d(xt, wt, b, padding=dil, dilation=dil)

        kernels.append({
            "name": f"window_conv {str(dtype)[6:]} {what} ({B},{T},{cin})"
                    f"->{cout} d={dil}",
            "route": "cuda",
            "source": "svcc23_fastsvc_tpu_torch/csrc/window_conv.cu",
            "replaces": "svcc23_fastsvc_tpu/ops/pallas_window_conv.py:155",
            "launches": launches["window_conv"],
            "max_abs_err": err,
            "ms": cuda_ms(kern),
            "plain_ms": cuda_ms(lambda: window_conv_plain(x, w, b, dil, slope)),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": cuda_ms(lib),
            "variant": fwd_plan(dtype, B, T, cin, cout)["variant"],
            "device_ms": queued_ms(kern),
            "library_device_ms": queued_ms(lib),
        })
    for b_, tf_, hop_, sr_ in SINE_SHAPES:
        f, err = sine_cases[(b_, tf_, hop_, sr_)]
        nbytes = f.numel() * 4 + b_ * tf_ * hop_ * 4
        s_ms, s_by = bound(nbytes, 10 * b_ * tf_ * hop_, torch.float32)

        def sine(f=f, h=hop_, r=sr_):
            sine_excitation(f, hop=h, sr=r, amp=0.1)
        kernels.append({
            "name": f"sine_excitation f32 ({b_},{tf_}) hop {hop_} sr {sr_}",
            "route": "cuda",
            "source": "svcc23_fastsvc_tpu_torch/csrc/sine_excitation.cu",
            "replaces": "svcc23_fastsvc_tpu/ops/pallas_kernels.py:94",
            "launches": launches["sine_excitation"],
            "max_abs_err": err,
            "ms": cuda_ms(sine),
            "plain_ms": cuda_ms(lambda f=f, h=hop_, r=sr_: (
                sine_excitation_plain(f, hop=h, sr=r, amp=0.1))),
            "bound_ms": s_ms,
            "bound_by": s_by,
            "library_ms": None,
            "device_ms": queued_ms(sine),
        })
    for k in kernels:
        say(f"{k['name']}: {k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, "
            f"library {k['library_ms']}, bound {k['bound_ms']:.4f} by "
            f"{k['bound_by']})" + (
                f"; {k['variant']}, device {k['device_ms']:.4f} ms, library "
                f"device {k['library_device_ms']:.4f} ms"
                if "variant" in k else
                f"; device {k['device_ms']:.4f} ms" if "device_ms" in k
                else ""))
    phases["timings_s"] = time.perf_counter() - t

    # 6. profile: device time by kernel, and the device's busy share
    t = time.perf_counter()
    for dtype, g in ((torch.float32, g32), (torch.bfloat16, g16)):
        def batch(g=g):
            synthesize(g, sg, ppg, f0_in, lft, emb, generator_rng=rng)
        batch()
        torch.cuda.synchronize()
        t_wall = time.perf_counter()
        for _ in range(3):
            batch()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t_wall) * 1e3 / 3
        per_kernel = device_ms(batch)
        busy = sum(per_kernel.values())
        say(f"profile decode {str(dtype)[6:]}: wall {wall_ms:.3f} ms/batch, "
            f"kernels {busy:.3f} ms, busy {busy / wall_ms:.1%}")
        for kname, ms in list(per_kernel.items())[:12]:
            say(f"  {ms:8.4f} ms {ms / busy:6.1%}  {kname[:110]}")
    for b_, tf_, hop_, sr_ in SINE_SHAPES:
        f = sine_cases[(b_, tf_, hop_, sr_)][0]
        per_kernel = device_ms(lambda f=f, h=hop_, r=sr_: sine_excitation(
            f, hop=h, sr=r, amp=0.1), n=5)
        say(f"profile sine_excitation ({b_},{tf_}) hop {hop_}: " + ", ".join(
            f"{kname} {ms * 1e3:.2f} us" for kname, ms in per_kernel.items()))
    phases["profile_s"] = time.perf_counter() - t

    # 7. one training step of each phase on the card against the CPU;
    # phases 7-9 run with cuDNN's deterministic algorithms, as the
    # training CLI does (decode and synthesis leave cuDNN at its defaults)
    t = time.perf_counter()
    from svcc23_fastsvc_tpu_torch.bin.common import deterministic_cudnn
    from svcc23_fastsvc_tpu_torch.config import build_train_task
    from svcc23_fastsvc_tpu_torch.data.collate import FastSVCBatcher
    from svcc23_fastsvc_tpu_torch.data.wire import to_device

    deterministic_cudnn()
    items = recipe_dataset()
    train_vs_cpu(dev, items)
    phases["train_vs_cpu_s"] = time.perf_counter() - t

    # 8. the recipe's batch through Trainer.run, both phases, bf16 and f32
    t = time.perf_counter()
    counters = (window_conv, window_conv_dx, window_conv_wgrad,
                sine_excitation)
    train_rates, train_launches = trainer_run(dev, items, counters)
    phases["train_s"] = time.perf_counter() - t

    # 9. profile one bf16 gan_step
    t = time.perf_counter()
    cfg = {**TRAIN_CONFIG, "compute_dtype": "bfloat16"}
    task = build_train_task(cfg, device=dev, seed=7)
    batcher = FastSVCBatcher(items, batch_size=TB, batch_length=16000,
                             hop_size=HOP, seed=2)
    tbatch = to_device(batcher.sample_batch(), dev)
    for _ in range(2):
        task.gan_step(tbatch)
    torch.cuda.synchronize()
    t_wall = time.perf_counter()
    for _ in range(3):
        task.gan_step(tbatch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t_wall) * 1e3 / 3
    # one profiled step, as phases 18 and 22 profile theirs (three until
    # phase 30 was added: this cut helps pay for it)
    per_kernel = device_ms(lambda: task.gan_step(tbatch), n=1,
                           host_ops=False)
    busy = sum(per_kernel.values())
    say(f"profile gan_step bf16 (B={TB} x 16000): wall {wall_ms:.3f} ms/step, "
        f"kernels {busy:.3f} ms, busy {busy / wall_ms:.1%}")
    step_profile = {"wall_ms": wall_ms, "kernels_ms": busy,
                    "busy": busy / wall_ms}
    for kname, ms in list(per_kernel.items())[:20]:
        say(f"  {ms:8.4f} ms {ms / busy:6.1%}  {kname[:110]}")
    del task
    phases["train_profile_s"] = time.perf_counter() - t

    # 10. the backward kernels' times at the training shapes, beside cuDNN's
    # at its defaults (its deterministic wgrad is far slower at Cin = 1)
    torch.backends.cudnn.deterministic = False
    t = time.perf_counter()
    tgrad = torch.nn.grad
    for dtype, what, T, cin, cout, dil, slope, x, g, w, errs in grad_cases:
        esize = x.element_size()
        ops = 2 * TB * T * 3 * cin * cout
        xt = (torch.nn.functional.leaky_relu(x, slope) if slope else x)
        xt = xt.transpose(1, 2).contiguous()
        gt = g.transpose(1, 2).contiguous()
        wt = w.permute(2, 1, 0).contiguous()
        shape = f"({TB},{T},{cin})->{cout} d={dil}"
        # dx reads x only for the leaky mask (the wrapper passes no x
        # without a slope)
        dx_bytes = ((x.numel() + g.numel() + w.numel()) * esize
                    + (x.numel() * esize if slope is not None else 0))
        wg_bytes = (x.numel() + g.numel()) * esize + (w.numel() + cout) * 4
        for kernel, nbytes, err, fn, plain, lib, src, line, variant in (
            ("window_conv_dx", dx_bytes, errs["dx"][0],
             lambda: window_conv_dx(g, w, dil, x, slope),
             lambda: window_conv_dx_plain(g, w, dil, x, slope),
             lambda: tgrad.conv1d_input(xt.shape, wt, gt, padding=dil,
                                          dilation=dil),
             "window_conv_grad.cu", 252,
             fwd_plan(dtype, TB, T, cout, cin)["variant"]),
            ("window_conv_wgrad", wg_bytes,
             max(errs["dw"][0], errs["db"][0]),
             lambda: window_conv_wgrad(x, g, 3, dil, slope),
             lambda: window_conv_wgrad_plain(x, g, 3, dil, slope),
             lambda: tgrad.conv1d_weight(xt, wt.shape, gt, padding=dil,
                                           dilation=dil),
             "window_conv_grad.cu", 203,
             wgrad_plan(dtype, TB, T, 3, cin, cout)["variant"]),
        ):
            b_ms, b_by = bound(nbytes, ops, dtype)
            kernels.append({
                "name": f"{kernel} {str(dtype)[6:]} {what} {shape}",
                "route": "cuda",
                "source": f"svcc23_fastsvc_tpu_torch/csrc/{src}",
                "replaces": f"svcc23_fastsvc_tpu/ops/pallas_window_conv.py:"
                            f"{line}",
                "launches": train_launches[kernel],
                "max_abs_err": err,
                "ms": cuda_ms(fn),
                "plain_ms": cuda_ms(plain),
                "bound_ms": b_ms,
                "bound_by": b_by,
                "library_ms": cuda_ms(lib),
                "variant": variant,
                "device_ms": queued_ms(fn),
                "library_device_ms": queued_ms(lib),
            })
            k = kernels[-1]
            say(f"{k['name']}: {k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, "
                f"library {k['library_ms']:.4f}, bound {k['bound_ms']:.4f} "
                f"by {k['bound_by']}); {variant}, device "
                f"{k['device_ms']:.4f} ms, library device "
                f"{k['library_device_ms']:.4f} ms")
    phases["grad_timings_s"] = time.perf_counter() - t

    # 11-14. the B02 vocoder, with cuDNN at its defaults as in synthesize_b02
    voc_rows, voc_launches = vocoder_phases(dev, phases)
    kernels += voc_rows

    # 15-16. the down chain, and decode with it
    down_rows, down_launches = down_chain_phases(
        dev, phases, {torch.float32: g32, torch.bfloat16: g16}, sg,
        (ppg, f0_in, lft, emb), rng_states, ys, decode_rate)
    kernels += down_rows

    # 17-20. the fused conv's kernels, FastSVC training and decode with the
    # switch on, and B02 decode
    fused_rows, fused_paths = fused_conv_phases(
        dev, phases, items, {torch.float32: g32, torch.bfloat16: g16}, sg,
        (ppg, f0_in, lft, emb), rng_states, ys, decode_rate, train_rates)
    kernels += fused_rows

    # 21. the recipe's steps_per_call 8: captured K-step calls
    t = time.perf_counter()
    k_launches = k_step_phase(dev, items, (window_conv, window_conv_dx,
                                           window_conv_wgrad, sine_excitation),
                              train_rates, step_profile)
    phases["train_k_steps_s"] = time.perf_counter() - t
    say(f"phase 21 (K = {KSTEPS} steps a call): "
        f"{phases['train_k_steps_s']:.1f} s")

    # 22. B02 acoustic-model training at the recipe's width
    t = time.perf_counter()
    b02_rows, b02_paths = b02_train_phase(dev, phases)
    kernels += b02_rows
    say(f"phase 22 (B02 training): {time.perf_counter() - t:.1f} s")

    # 23. the front end (recipe stages 0-3) on the card, then decode
    t = time.perf_counter()
    fe_launches = front_end_phase(dev, phases, g32, sg)
    say(f"phase 23 (front end -> decode): {time.perf_counter() - t:.1f} s")

    # 24. the B02 front end (recipe stages 0-3) on the card, then conversion
    t = time.perf_counter()
    b02_fe_launches = b02_front_end_phase(dev, phases)
    say(f"phase 24 (B02 front end -> conversion): "
        f"{time.perf_counter() - t:.1f} s")

    train_counters = (window_conv, window_conv_dx, window_conv_wgrad,
                      sine_excitation)
    # 25. the recipe's loader_threads: 4, the native batch producer
    t = time.perf_counter()
    loader_launches, loader_rates = loader_phase(dev, items, train_counters)
    phases["loader_s"] = time.perf_counter() - t
    say(f"phase 25 (the recipe's loader at K = {KSTEPS}): "
        f"{phases['loader_s']:.1f} s")

    # 26. B02 training at K steps a call, captured
    t = time.perf_counter()
    b02_k_launches, _ = b02_k_step_phase(
        dev, (window_conv, window_conv_dx, window_conv_wgrad))
    phases["b02_k_steps_s"] = time.perf_counter() - t
    say(f"phase 26 (B02 K-step graphs): {phases['b02_k_steps_s']:.1f} s")

    # 27. the HiFiGAN discriminator
    t = time.perf_counter()
    hifi_rows, hifi_launches, _ = hifigan_phase(dev, items, train_counters)
    kernels += hifi_rows
    phases["hifigan_s"] = time.perf_counter() - t
    say(f"phase 27 (HiFiGAN gan_step): {phases['hifigan_s']:.1f} s")

    # 28. Trainer.run: warm-up fast-forward, dumps, profile_dir
    t = time.perf_counter()
    options_launches = trainer_options_phase(dev, items, train_counters)
    phases["trainer_options_s"] = time.perf_counter() - t
    say(f"phase 28 (trainer options): {phases['trainer_options_s']:.1f} s")

    # 29. both recipe drivers through the port's CLIs
    t = time.perf_counter()
    keep_dir = tempfile.mkdtemp(prefix="chip_smoke_dp_dumps_")
    recipes = recipe_drivers_phase(dev, phases, keep_dir)
    phases["recipe_drivers_s"] = time.perf_counter() - t
    say(f"phase 29 (recipe drivers): {phases['recipe_drivers_s']:.1f} s")

    # 30. data parallelism: two gloo ranks sharing the card, one NCCL rank
    # captured at K = 8, the training CLI as two ranks
    t = time.perf_counter()
    dp_paths = dp_phase(dev, items, keep_dir, train_counters,
                        loader_rates["loader_threads 4"])
    phases["data_parallel_s"] = time.perf_counter() - t
    say(f"phase 30 (data parallel): {phases['data_parallel_s']:.1f} s")
    recipe_paths = {}
    for recipe in RECIPE_CONF:
        total = {}
        for row in recipes[recipe]["stages"].values():
            for k, v in row["launches"].items():
                total[k] = total.get(k, 0) + v
        recipe_paths[f"recipe_{recipe}"] = total
    paths = {"decode": launches, "train": train_launches, **voc_launches,
             "decode_chain": down_launches, **fused_paths,
             "train_k_steps": k_launches, **b02_paths,
             "front_end_decode": fe_launches,
             "b02_front_end_conversion": b02_fe_launches,
             "train_loader_k8": loader_launches,
             "b02_train_k_steps": b02_k_launches,
             "train_hifigan": hifi_launches,
             "train_options": options_launches, **recipe_paths,
             **dp_paths}
    for row in kernels:
        name = row["name"].split(" ")[0]
        row["launches_by_path"] = {p: n.get(name, 0) for p, n in paths.items()}
    # every counting wrapper has a row (the down chain's weight pack is
    # #7's, reported beside its row as pack_launches)
    from svcc23_fastsvc_tpu_torch.ops import counted_kernels

    rowless = ({k.__name__ for k in counted_kernels()} - {"pack_weights"}
               - {row["name"].split(" ")[0] for row in kernels})
    require(not rowless, f"kernels with no row in the kernels line: "
            f"{sorted(rowless)}")
    phases["total_s"] = time.perf_counter() - _T0
    say(f"phases: {phases}")

    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:  # one rank of phase 30(a)
        dp_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        main()
    faulthandler.cancel_dump_traceback_later()
