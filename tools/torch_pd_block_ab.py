#!/usr/bin/env python3
"""Time the port's vocoder gated-block kernels (#8 fixed, #10 adaptive),
the fused conv's one-pass backward (#6) and a whole B02 vocoder batch, at
chip_smoke.py's shapes, from the checkout at --root.

    python3 tools/torch_pd_block_ab.py --root . --label change --out DIR
    python3 tools/torch_pd_block_ab.py --root PARENT --label parent --out DIR

Run it on a CUDA machine for two checkouts in turns (parent, change,
change, parent) to compare two versions on one card. Each kernel row gets
the event time of 20 back-to-back calls as the host issues them (ms) and
the device time per call with the host's cost left out (device_ms: 20
calls queued behind a spin kernel, CUDA events). The vocoder row is the
batch time of 8 x 1 s through `bin/synthesize_b02.py::vocode` (CUDA
events, 5 batches) at the vocoder's full width with random weights from a
seed. The rows go to stdout and, as JSON, to DIR/pd_block_ab_<label>.json.
Imports torch, numpy and the package at --root only.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

VB, VT, VHOP, VSR = 8, 24000, 160, 24000
R, G, A = 64, 128, 62
# (kernel, dilation): chip_smoke.py's block rows
PD_ROWS = [("adaptive", 1), ("adaptive", 8), ("fixed", 1), ("fixed", 512)]
TB, B = 32, 8
# (what, B, T, Cin, Cout, dilation, input leaky): chip_smoke.py's #6 rows
FUSED = [("train down conv1", TB, 16000, 1, 24, 1, 0.2),
         ("train up conv3", TB, 16000, 24, 24, 27, 0.2),
         ("train up3 conv2", TB, 3200, 48, 48, 9, 0.2),
         ("train up2 conv1", TB, 800, 96, 96, 3, 0.2),
         ("decode down conv1", B, 64000, 1, 24, 1, 0.2),
         ("decode up1 conv_first", B, 400, 144, 192, 1, None),
         ("tacotron2 bap conv1", 4, 400, 86, 43, 2, None)]
VOC_CONFIG = {
    "sampling_rate": VSR, "hop_size": VHOP, "aux_context_window": 2,
    "dense_factor": 4,
    "generator_params": {"upsample_params": {"upsample_scales": [5, 4, 4, 2]},
                         "aux_channels": A},
    "signal_generator": {"sine_amp": 0.1, "noise_amp": 0.003,
                         "signal_types": ["sine", "noise"]},
}


def event_ms(fn, iters=20, warmup=3):
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


def queued_ms(fn, iters=20, spin_cycles=200_000_000):
    """Device ms per call: `iters` calls enqueued behind a spin kernel that
    holds the stream until the host has enqueued them all, timed with CUDA
    events. Raises if the host took longer to enqueue than the spin."""
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
    if enqueue_ms >= spin0.elapsed_time(start):
        raise RuntimeError(f"enqueue took {enqueue_ms:.2f} ms, longer than "
                           "the spin")
    return start.elapsed_time(end) / iters


def block_params(kind, rng, dtype, dev):
    """Random block weights as the vocoder passes them: WIO views of
    torch-layout (O, I, K) parameters."""
    def conv(K, cin, cout, bias=True):
        w = torch.from_numpy((rng.standard_normal((cout, cin, K))
                              / np.sqrt(K * cin)).astype(np.float32))
        p = {"w": w.to(dev, dtype).permute(2, 1, 0)}
        if bias:
            p["b"] = torch.from_numpy((0.1 * rng.standard_normal(cout))
                                      .astype(np.float32)).to(dev, dtype)
        return p
    if kind == "fixed":
        p = {"conv": conv(3, R, G)}
    else:
        p = {k: conv(1, R, G) for k in ("convC", "convP", "convF")}
    p["aux"] = conv(1, A, G, bias=False)
    p["out"] = conv(1, G // 2, R)
    return p


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--out", default=".", help="directory for the JSON")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    from svcc23_fastsvc_tpu_torch.bin.synthesize_b02 import (
        signal_generator,
        vocode,
    )
    from svcc23_fastsvc_tpu_torch.config import build_vocoder
    from svcc23_fastsvc_tpu_torch.dsp.f0 import dilated_factor
    from svcc23_fastsvc_tpu_torch.models.hnusfgan import PD_HALO_FS
    from svcc23_fastsvc_tpu_torch.ops import _build
    from svcc23_fastsvc_tpu_torch.ops.fused_conv import fused_conv1d_bwd
    from svcc23_fastsvc_tpu_torch.ops.pd_block import (
        frame_shifts,
        pd_adaptive_block,
        pd_block_halo,
        pd_fixed_block,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    t = time.perf_counter()
    _build.build()
    print(f"[{args.label}] {smi}; build {time.perf_counter() - t:.1f} s",
          flush=True)
    dev = torch.device("cuda")
    rows = []

    def run(kernel, what, dtype, fn):
        row = {"kernel": kernel, "what": what, "dtype": str(dtype)[6:],
               "ms": event_ms(fn), "device_ms": queued_ms(fn)}
        rows.append(row)
        print(f"[{args.label}] {kernel} {row['dtype']} {what}: "
              f"{row['ms']:.4f} ms, device {row['device_ms']:.4f} ms",
              flush=True)

    r = np.random.default_rng(12)
    frames = VT // VHOP
    f0 = np.where(r.random((VB, frames)) > 0.2,
                  r.uniform(80, 400, (VB, frames)), 0.0).astype(np.float32)
    df = np.stack([np.repeat(dilated_factor(f, VSR, 4), VHOP) for f in f0])
    df_d = torch.from_numpy(df.astype(np.float32)).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(r.standard_normal((VB, VT, R)).astype(
            np.float32)).to(dev, dtype)
        c = torch.from_numpy(r.standard_normal((VB, VT, A)).astype(
            np.float32)).to(dev, dtype)
        for kind, dil in PD_ROWS:
            params = block_params(kind, np.random.default_rng(dil), dtype, dev)
            if kind == "adaptive":
                shifts = frame_shifts(df_d, dil, VHOP,
                                      pd_block_halo(dil, PD_HALO_FS, hop=VHOP))
                fn = (lambda p=params, s=shifts:
                      pd_adaptive_block(x, c, s, p, hop=VHOP))
            else:
                fn = (lambda p=params, d=dil:
                      pd_fixed_block(x, c, p, dilation=d))
            run(f"pd_{kind}_block", f"({VB},{VT},{R}|{A})->{R} d={dil}",
                dtype, fn)
        del x, c
        for what, nb, T, cin, cout, dil, slope in FUSED:
            gen = torch.Generator(device=dev).manual_seed(17)
            x = torch.randn((nb, T, cin), generator=gen, device=dev).to(dtype)
            g = torch.randn((nb, T, cout), generator=gen, device=dev).to(dtype)
            w = (torch.randn((3, cin, cout), generator=gen, device=dev)
                 / (3 * cin) ** 0.5).to(dtype)
            run("fused_conv1d_bwd",
                f"{what} ({nb},{T},{cin})->{cout} d={dil}", dtype,
                lambda: fused_conv1d_bwd(x, g, w, dil, dil, dil, slope))
            del x, g, w

    # the B02 vocoder, 8 x 1 s through vocode, both dtypes
    init = torch.Generator().manual_seed(11)
    v32 = build_vocoder(VOC_CONFIG, generator=init).fold_weight_norm_()
    v32 = v32.to(dev).eval()
    sg = signal_generator(VOC_CONFIG)
    aux = torch.from_numpy(r.standard_normal((VB, frames + 4, A)).astype(
        np.float32)).to(dev)
    f0_d = torch.from_numpy(f0[:, :, None]).to(dev)
    rng = torch.Generator(device=dev).manual_seed(14)
    for dtype in (torch.float32, torch.bfloat16):
        voc = v32.to(dtype)
        ms = event_ms(lambda: vocode(voc, sg, f0_d, aux, df_d,
                                     generator_rng=rng), iters=5, warmup=2)
        rows.append({"kernel": "vocoder", "what": f"{VB} x 1 s",
                     "dtype": str(dtype)[6:], "batch_ms": ms})
        print(f"[{args.label}] vocoder {str(dtype)[6:]} {VB} x 1 s: "
              f"{ms:.3f} ms a batch", flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"pd_block_ab_{args.label}.json"),
              "w") as f:
        json.dump({"label": args.label, "gpu": smi, "rows": rows}, f,
                  indent=1)


if __name__ == "__main__":
    main()
