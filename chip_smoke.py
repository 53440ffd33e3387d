#!/usr/bin/env python3
"""Drive the PyTorch port's FastSVC decode and training paths and the B02
vocoder's synthesis on one H100, each fused-chain mode too.

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
   in-memory dataset in FastSVCDataset's layout), 20 gen_steps then 20
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
   8 x 24000 samples, f32 and bf16, with their times.
12. vocoder: the B02 HN-uSFGAN generator at full width (20 adaptive, 5 noise
   and 30 filter blocks, random weights from a seed, weight norm folded)
   vocodes 8 utterances of 1 s through `bin/synthesize_b02.py::vocode` in
   f32 and bf16: exactly 20 adaptive and 35 fixed kernel launches per
   forward, finite output, utterances 0 and 7 held against the same module
   on the CPU (plain versions; bf16 within twice the CPU's own bf16-vs-f32
   distance), audio-s/s by CUDA events and the busy share.
13. vocoder chain kernel: `pd_fixed_chain` against its plain version on the
   vocoder's own weights at 8 x 24000 samples, f32 and bf16, for the noise
   net's (1, 1, 1, 1, 1) and a filter cycle's (1, 2, 4, 8, 16): its error,
   whether it equals the block kernels bit for bit, its time, its plain
   version's, and the time of the five `pd_fixed_block` launches it
   replaces.
14. vocoder with FASTSVC_PD_CHAIN=5: the same batches through `vocode`,
   exactly 20 adaptive, 4 chain and 15 fixed launches per forward, the
   output against phase 12's (f32 within 1e-5 of max |y|; bit identity
   reported) and against the CPU as in phase 12, rates and busy share
   beside phase 12's.
15. down chain: `down_chain_fwd` against its plain version on the
   generator's DownsampleBlocks at the four decode shapes (8 x 4 s) and
   the JAX A/B tool's two (batch 32), f32 and bf16, with its time, its
   plain version's, and the time of the three window convs and the
   residual it replaces.
16. decode with the down-chain mode on: the batches of phase 4 through
   `synthesize`, exactly 36 window-conv, 8 down-chain and 1 sine launches
   per forward, all 8 utterances against the CPU as in phase 4, the
   difference from phase 4's output, and batch times beside phase 5's.

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
# the B02 vocoder (the JAX package's default HNUSFGANGenerator, as its bench
# runs it): 24 kHz, hop 160, batch 8 x 1 s; f0 80-400 Hz, 20% unvoiced
VB, VTF, VHOP, VSR = 8, 150, 160, 24000
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
                            + ("506" if kind == "adaptive" else "222"),
                "max_abs_err": err,
                "ms": cuda_ms(lambda: fn(*args, **kw)),
                "plain_ms": cuda_ms(lambda: plain(*args, **kw), iters=5,
                                    warmup=1),
                "bound_ms": b_ms,
                "bound_by": b_by,
                "library_ms": None,
            })
            k = rows[-1]
            say(f"{k['name']}: max err {err:.3e} (scale {scale:.3e}); "
                f"{k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, library none, "
                f"bound {k['bound_ms']:.4f} by {k['bound_by']})")
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
                "equals_the_block_kernels": same,
            })
            k = chain_cases[-1]
            say(f"{k['name']}: max err {err:.3e} (scale {scale:.3e}); "
                f"{k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, the {len(dils)}"
                f" block launches it replaces {k['replaced_ms']:.4f}, library "
                f"none, bound {k['bound_ms']:.4f} by {k['bound_by']}); equal "
                f"to the block kernels bit for bit: {same}")
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
             sine_excitation), [20, 4, 15, 1], "vocoder with chains")
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
            say(f"{k['name']}: max err {err:.3e} (scale {scale:.3e}); "
                f"{k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, the 3 window "
                f"convs + residual it replaces {k['replaced_ms']:.4f}, "
                f"library none, bound {k['bound_ms']:.4f} by {k['bound_by']})")
            del x, y, ref
    phases["down_chain_kernels_s"] = time.perf_counter() - t

    # 16. decode with the down-chain mode on, f32 then bf16
    t = time.perf_counter()
    ppg, f0_in, lft, emb = inputs
    rng = torch.Generator(device=dev)
    counters = (window_conv, down_chain_fwd, sine_excitation)
    for k in counters:
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
        launches = {k.__name__: k.launches for k in counters}
        say(f"decode with the down chain, main path: launches {launches}")
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
    finally:
        set_down_chain_mode("0")
    say(f"decode {B} x {TF * HOP / SR:.0f} s with the down chain: {rate}; "
        f"without (phase 5): {rate_off}")
    phases["decode_chain_s"] = time.perf_counter() - t
    for row in rows:
        row["launches"] = launches["down_chain_fwd"]
    return rows, launches


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

    # 7. one training step of each phase on the card against the CPU;
    # phases 7-9 run with cuDNN's deterministic algorithms, as the
    # training CLI does (decode and synthesis leave cuDNN at its defaults)
    t = time.perf_counter()
    from svcc23_fastsvc_tpu_torch.bin.common import deterministic_cudnn
    from svcc23_fastsvc_tpu_torch.config import build_train_task
    from svcc23_fastsvc_tpu_torch.data.collate import FastSVCBatcher
    from svcc23_fastsvc_tpu_torch.data.wire import to_device
    from svcc23_fastsvc_tpu_torch.train.checkpoint import load_checkpoint
    from svcc23_fastsvc_tpu_torch.train.loop import Trainer

    deterministic_cudnn()
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

    # two gan_steps from one state give the same gradients, bit for bit
    items = recipe_dataset()
    rbatch = to_device(FastSVCBatcher(items, batch_size=TB,
                                      batch_length=16000, hop_size=HOP,
                                      seed=3).sample_batch(), dev)
    repeat = {}
    for dt_name in ("float32", "bfloat16"):
        runs = []
        for _ in range(2):
            task = build_train_task({**TRAIN_CONFIG, "compute_dtype": dt_name},
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
    say(f"gan_step twice from one state (B={TB} x 16000): gradient tensors "
        f"that differ {repeat} (cudnn.deterministic "
        f"{torch.backends.cudnn.deterministic})")
    phases["train_vs_cpu_s"] = time.perf_counter() - t

    # 8. the recipe's batch through Trainer.run, both phases, bf16 and f32
    t = time.perf_counter()
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

    # 11-14. the B02 vocoder, with cuDNN at its defaults as in synthesize_b02
    voc_rows, voc_launches = vocoder_phases(dev, phases)
    kernels += voc_rows

    # 15-16. the down chain, and decode with it
    down_rows, down_launches = down_chain_phases(
        dev, phases, {torch.float32: g32, torch.bfloat16: g16}, sg,
        (ppg, f0_in, lft, emb), rng_states, ys, decode_rate)
    kernels += down_rows
    paths = {"decode": launches, "train": train_launches, **voc_launches,
             "decode_chain": down_launches}
    for row in kernels:
        name = row["name"].split(" ")[0]
        row["launches_by_path"] = {p: n.get(name, 0) for p, n in paths.items()}
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
