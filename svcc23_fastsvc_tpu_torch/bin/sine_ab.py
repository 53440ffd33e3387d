#!/usr/bin/env python3
"""Time the sine-excitation kernel (#1) of the checkout at --root at
chip_smoke.py's four shapes, to compare two versions on one card.

    python3 svcc23_fastsvc_tpu_torch/bin/sine_ab.py --root . --label change
    python3 svcc23_fastsvc_tpu_torch/bin/sine_ab.py --root PARENT --label parent

Run it on a CUDA machine for two checkouts in turns (parent, change,
change, parent), from one copy of this file: it imports the package at
--root, whatever version that is, and builds its kernels there. Each row
is a (B, Tf, hop, sr) of f32 frame F0 (80-400 Hz, 20% unvoiced, from a
seed): the decode batch (8, 400, 160, 16 kHz), the training batch (32,
100), the vocoder's 8 x 1 s (8, 150, 160, 24 kHz) and a 30 s bucket (8,
3000). It gets the device time per call (20 calls queued behind a spin
kernel, CUDA events: the host's cost of a call left out), the event time
of 20 calls as the host issues them, the bound (output and f0 bytes over
3.35 TB/s) and the kernels a call launches in the profile. The rows go to
stdout and, as JSON, to --out/sine_ab_<label>.json when --out is given.
"""

import argparse
import json
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

SHAPES = [(8, 400, 160, 16000), (32, 100, 160, 16000), (8, 150, 160, 24000),
          (8, 3000, 160, 16000)]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM


def queued_ms(fn, iters=20, spin_cycles=50_000_000):
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
        raise RuntimeError("the host took longer to enqueue than the spin")
    return start.elapsed_time(end) / iters


def event_ms(fn, iters=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernels_a_call(fn, n=3):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(names) / n


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sine_ab.py times the kernel on a CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from svcc23_fastsvc_tpu_torch.ops.sine import sine_excitation

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for b, tf, hop, sr in SHAPES:
        voiced = torch.rand((b, tf), generator=gen, device=dev) > 0.2
        f0 = torch.where(voiced, 80 + 320 * torch.rand(
            (b, tf), generator=gen, device=dev), torch.zeros((b, tf),
                                                             device=dev))

        def call(f0=f0, hop=hop, sr=sr):
            sine_excitation(f0, hop=hop, sr=sr, amp=0.1)
        rows.append({
            "shape": [b, tf, hop, sr], "label": args.label,
            "device_ms": queued_ms(call), "event_ms": event_ms(call),
            "bound_ms": (f0.numel() + b * tf * hop) * 4 / HBM_BYTES_PER_S
            * 1e3,
            "kernels_a_call": kernels_a_call(call),
        })
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"sine_ab_{args.label}.json"),
                  "w") as f:
            json.dump({"device": torch.cuda.get_device_name(0),
                       "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
