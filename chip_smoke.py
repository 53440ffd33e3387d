#!/usr/bin/env python3
"""Drive the PyTorch port's FastSVC decode and training paths on one H100.

    python3 chip_smoke.py        # from the repository root, on a CUDA machine

Phases, each printed on one line with its elapsed seconds:

1. device: require CUDA; print the card's name and power limit.
2. build: compile `svcc23_fastsvc_tpu_torch/csrc/*.cu` with nvcc (sm_90a).
3. kernels: each kernel against its plain PyTorch version, in f32 (TF32
   off) and bf16: the forward at the decode shapes of a 400-frame batch of
   8, dx and wgrad at the training shapes of the recipe's batch (32 x 16000
   samples); the sine also at a 3000-frame (30 s) bucket.
4. decode: a full-width generator (conf/fastsvc.yaml widths, random
   weights from a seed) converts 8 utterances of 4 s through `synthesize`
   at f32 and bf16; the kernel launch counts of that run are read, the
   output checked finite, and all 8 utterances of each batch held against
   the same module, in the same dtype, on the CPU (plain versions), fed
   the same excitation noise the card drew.
5. timings: decode audio-s/s, and per kernel its time, its plain version's
   time, one PyTorch library call for the same function where there is
   one, and its bound (bytes over 3.35 TB/s or operations over the dtype's
   peak, the larger).
6. profile: under `torch.profiler`, the device time of each kernel of one
   decode batch (f32, bf16) and the device's busy share of the batch's
   wall time; the sine kernels' device time at 400 and 3000 frames.
7. train step vs CPU: the recipe's generator and MelGAN discriminator at
   full width (random weights from a seed), one gen_step and one gan_step,
   each from the seed's weights, on a batch of 2 x 16000 samples with an
   explicit excitation, in f32 on the card and on the CPU (plain versions)
   and in f64 on the CPU: every loss and every G and D gradient of the
   card within 4x the CPU f32's own distance from f64 (plus a margin), and
   finite updated weights.
8. train: `Trainer.run` on the recipe's batch (32 x 16000 samples, an
   in-memory dataset in FastSVCDataset's layout), 20 gen_steps then 20
   gan_steps, in bf16 (packed wire) and f32 (f32 wire): finite losses, the
   kernel launches of each step, steps/s and audio-s/s of each phase's
   second log interval of 10 steps (the Trainer's own rate, CUDA
   synchronized before the clock stops), peak device memory, and the last
   checkpoint reloaded into a fresh task.
9. profile: one bf16 gan_step under `torch.profiler`: device time per
   kernel and the busy share.

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
import subprocess
import sys
import tempfile
import time

WATCHDOG_S = 300
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
TOL_SINE = 2e-4
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


def device_ms(fn, n=3):
    """Device ms per call of each kernel `fn` launches (torch.profiler rows
    with device time and no host time), largest first."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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


def random_f0(gen, dev, tf):
    voiced = torch.rand((B, tf), generator=gen, device=dev) > 0.2
    return torch.where(voiced,
                       80 + 320 * torch.rand((B, tf), generator=gen, device=dev),
                       torch.zeros((B, tf), device=dev))


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
            grad_cases.append((dtype, what, T, cin, cout, dil, slope, x, g, w,
                               errs))
            say(f"window_conv dx/wgrad {str(dtype)[6:]} {what} "
                f"({TB},{T},{cin})->{cout} d={dil}: " + ", ".join(
                    f"{n} max err {e:.3e} (scale {sc:.3e})"
                    for n, (e, sc) in errs.items()))
    f0 = random_f0(gen, dev, TF)
    f0_long = random_f0(gen, dev, TF_LONG)
    sine_err = {}  # by frame count
    for f in (f0, f0_long):
        s_k = sine_excitation(f, hop=HOP, sr=SR, amp=0.1)
        s_p = sine_excitation_plain(f, hop=HOP, sr=SR, amp=0.1)
        err = (s_k - s_p).abs().max().item()
        require(err <= TOL_SINE, f"sine_excitation {tuple(f.shape)}: max "
                                 f"err {err}")
        say(f"sine_excitation {tuple(f.shape)} hop {HOP}: max err {err:.3e}")
        sine_err[f.shape[1]] = err
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

    # the same module on the CPU (plain versions), on all 8 utterances of
    # each batch above; the CPU excitation is the plain sine plus the noise
    # term the card drew in that batch (the noise is torch.randn, not ported
    # code, and a CPU generator cannot draw the card's stream)
    sg0 = dataclasses.replace(sg, noise_amp=0.0)
    clean = sg0(f0_in)
    cpu_in = [v.cpu() for v in (ppg, f0_in, lft, emb)]
    decode_err = {}
    for dtype, g in ((torch.float32, g32), (torch.bfloat16, g16)):
        replay = torch.Generator(device=dev)
        replay.set_state(rng_states[dtype])
        noise = (sg(f0_in, replay) - clean).cpu()
        y_ref = synthesize(copy.deepcopy(g).cpu(),
                           lambda f, _rng, noise=noise: sg0(f) + noise,
                           *cpu_in, generator_rng=None)
        err = (ys[dtype].cpu() - y_ref).abs().max().item()
        scale = y_ref.abs().max().item()
        decode_err[str(dtype)[6:]] = {"max_abs_err": err, "max_abs_y": scale}
        require(err <= TOL_DECODE[dtype] * scale,
                f"decode {dtype} vs CPU plain: max err {err} > "
                f"{TOL_DECODE[dtype]} x {scale}")
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
        kernels.append({
            "name": f"window_conv {str(dtype)[6:]} {what} ({B},{T},{cin})"
                    f"->{cout} d={dil}",
            "route": "cuda",
            "source": "svcc23_fastsvc_tpu_torch/csrc/window_conv.cu",
            "replaces": "svcc23_fastsvc_tpu/ops/pallas_window_conv.py:155",
            "launches": launches["window_conv"],
            "max_abs_err": err,
            "ms": cuda_ms(lambda: window_conv(x, w, b, dil, slope)),
            "plain_ms": cuda_ms(lambda: window_conv_plain(x, w, b, dil, slope)),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": cuda_ms(lambda: torch.nn.functional.conv1d(
                xt, wt, b, padding=dil, dilation=dil)),
        })
    nbytes = f0.numel() * 4 + B * TF * HOP * 4
    s_ms, s_by = bound(nbytes, 10 * B * TF * HOP, torch.float32)
    kernels.append({
        "name": f"sine_excitation f32 ({B},{TF}) hop {HOP}",
        "route": "cuda",
        "source": "svcc23_fastsvc_tpu_torch/csrc/sine_excitation.cu",
        "replaces": "svcc23_fastsvc_tpu/ops/pallas_kernels.py:78",
        "launches": launches["sine_excitation"],
        "max_abs_err": sine_err[TF],
        "ms": cuda_ms(lambda: sine_excitation(f0, hop=HOP, sr=SR, amp=0.1)),
        "plain_ms": cuda_ms(
            lambda: sine_excitation_plain(f0, hop=HOP, sr=SR, amp=0.1)),
        "bound_ms": s_ms,
        "bound_by": s_by,
        "library_ms": None,
    })
    for k in kernels:
        say(f"{k['name']}: {k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, "
            f"library {k['library_ms']}, bound {k['bound_ms']:.4f} by "
            f"{k['bound_by']})")
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
    for f in (f0, f0_long):
        per_kernel = device_ms(
            lambda f=f: sine_excitation(f, hop=HOP, sr=SR, amp=0.1), n=5)
        say(f"profile sine_excitation {tuple(f.shape)}: " + ", ".join(
            f"{kname} {ms * 1e3:.2f} us" for kname, ms in per_kernel.items()))
    phases["profile_s"] = time.perf_counter() - t

    # 7. one training step of each phase on the card against the CPU
    t = time.perf_counter()
    from svcc23_fastsvc_tpu_torch.config import build_train_task
    from svcc23_fastsvc_tpu_torch.data.collate import FastSVCBatcher
    from svcc23_fastsvc_tpu_torch.data.wire import to_device
    from svcc23_fastsvc_tpu_torch.train.checkpoint import load_checkpoint
    from svcc23_fastsvc_tpu_torch.train.loop import Trainer

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
    losses, grads = {}, {}
    for phase in ("gen", "gan"):
        for label, where, dtype in (("cpu f64", "cpu", torch.float64),
                                    ("cpu f32", "cpu", torch.float32),
                                    ("card f32", dev, torch.float32)):
            task = build_train_task(TRAIN_CONFIG, device=where, seed=3)
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
    loss_rows = {}
    for k, ref in losses["cpu f64"].items():
        e_card = abs(losses["card f32"][k] - ref)
        e_cpu = abs(losses["cpu f32"][k] - ref)
        loss_rows[k] = (e_card / abs(ref), e_cpu / abs(ref))
        require(e_card <= F32_FACTOR * e_cpu + TOL_TRAIN_LOSS * abs(ref),
                f"train step {k}: card err {e_card}, CPU f32 err {e_cpu}, "
                f"f64 {ref}")
    grad_rows = {}
    for who, got, cpu, ref in zip(("G gen", "G gan", "D gan"),
                                  grads["card f32"], grads["cpu f32"],
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
    say(f"train step vs CPU f64 (card f32 and CPU f32, B=2 x 16000, "
        f"gen_step and gan_step each from the seed's weights): loss rel "
        f"errs (card, cpu f32) {loss_rows}")
    say(f"  gradients: {grad_rows}; card losses {losses['card f32']}")
    phases["train_vs_cpu_s"] = time.perf_counter() - t

    # 8. the recipe's batch through Trainer.run, both phases, bf16 and f32
    t = time.perf_counter()
    items = recipe_dataset()
    counters = (window_conv, window_conv_dx, window_conv_wgrad,
                sine_excitation)
    for c in counters:
        c.launches = 0
    train_rates, step_launches = {}, {}
    workdir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        for dt_name, wire in (("bfloat16", "packed"), ("float32", "f32")):
            cfg = {**TRAIN_CONFIG, "compute_dtype": dt_name,
                   "wire_format": wire}
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
                    "peak_mem_gib": peak / 2 ** 30,
                    "launches_per_step (fwd, dx, wgrad, sine)":
                        log[LOG_STEPS * timed],
                }
            step_launches[dt_name] = log
            say(f"train {dt_name} ({wire} wire): mean losses to step "
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
    train_launches = {"window_conv": window_conv.launches,
                      "window_conv_dx": window_conv_dx.launches,
                      "window_conv_wgrad": window_conv_wgrad.launches,
                      "sine_excitation": sine_excitation.launches}
    say(f"train main path: launches {train_launches}")
    for k, v in train_rates.items():
        say(f"train {k}: {v}")
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
    per_kernel = device_ms(lambda: task.gan_step(tbatch))
    busy = sum(per_kernel.values())
    say(f"profile gan_step bf16 (B={TB} x 16000): wall {wall_ms:.3f} ms/step, "
        f"kernels {busy:.3f} ms, busy {busy / wall_ms:.1%}")
    for kname, ms in list(per_kernel.items())[:20]:
        say(f"  {ms:8.4f} ms {ms / busy:6.1%}  {kname[:110]}")
    del task
    phases["train_profile_s"] = time.perf_counter() - t

    # 10. the backward kernels' times at the training shapes
    t = time.perf_counter()
    for row in kernels:
        row["launches_by_path"] = {
            "decode": row["launches"],
            "train": train_launches[row["name"].split(" ")[0]]}
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
        for kernel, nbytes, err, fn, plain, lib, src, line in (
            ("window_conv_dx", dx_bytes, errs["dx"][0],
             lambda: window_conv_dx(g, w, dil, x, slope),
             lambda: window_conv_dx_plain(g, w, dil, x, slope),
             lambda: tgrad.conv1d_input(xt.shape, wt, gt, padding=dil,
                                          dilation=dil),
             "window_conv_grad.cu", 252),
            ("window_conv_wgrad", wg_bytes,
             max(errs["dw"][0], errs["db"][0]),
             lambda: window_conv_wgrad(x, g, 3, dil, slope),
             lambda: window_conv_wgrad_plain(x, g, 3, dil, slope),
             lambda: tgrad.conv1d_weight(xt, wt.shape, gt, padding=dil,
                                           dilation=dil),
             "window_conv_grad.cu", 203),
        ):
            b_ms, b_by = bound(nbytes, ops, dtype)
            kernels.append({
                "name": f"{kernel} {str(dtype)[6:]} {what} {shape}",
                "route": "cuda",
                "source": f"svcc23_fastsvc_tpu_torch/csrc/{src}",
                "replaces": f"svcc23_fastsvc_tpu/ops/pallas_window_conv.py:"
                            f"{line}",
                "launches": train_launches[kernel],
                "launches_by_path": {"decode": 0,
                                     "train": train_launches[kernel]},
                "max_abs_err": err,
                "ms": cuda_ms(fn),
                "plain_ms": cuda_ms(plain),
                "bound_ms": b_ms,
                "bound_by": b_by,
                "library_ms": cuda_ms(lib),
            })
            k = kernels[-1]
            say(f"{k['name']}: {k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, "
                f"library {k['library_ms']:.4f}, bound {k['bound_ms']:.4f} "
                f"by {k['bound_by']})")
    phases["grad_timings_s"] = time.perf_counter() - t
    phases["total_s"] = time.perf_counter() - _T0
    say(f"phases: {phases}")

    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
    faulthandler.cancel_dump_traceback_later()
