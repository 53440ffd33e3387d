#!/usr/bin/env python3
"""Time the port's window-conv kernels (#2 forward, #3 dx, #4 wgrad, #5
fused forward) at chip_smoke.py's shapes, from the checkout at --root.

    python3 tools/torch_window_conv_ab.py --root . --label change --out DIR
    python3 tools/torch_window_conv_ab.py --root PARENT --label parent --out DIR

Run it on a CUDA machine for two checkouts in turns (parent, change,
change, parent) to compare two versions on one card. Each row gets the
event time of 20 back-to-back calls as the host issues them (ms), the
device time per call with the host's cost left out (device_ms: 20 calls
queued behind a spin kernel, CUDA events) and, from torch.profiler, the
device time of each kernel the call launches (by_kernel). The rows
go to stdout and, as JSON, to DIR/window_conv_ab_<label>.json. Imports
torch and the package at --root only.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

B, TB = 8, 32
# (what, B, T, Cin, Cout, dilation, input leaky), chip_smoke.py's rows
FWD = [("down conv1", B, 64000, 1, 24, 1, 0.2),
       ("up conv3", B, 64000, 24, 24, 27, 0.2),
       ("up3 conv2", B, 12800, 48, 48, 9, 0.2),
       ("up1 conv_first", B, 400, 144, 192, 1, None),
       ("up1 FiLM", B, 800, 384, 384, 1, None)]
GRAD = [("down conv1", TB, 16000, 1, 24, 1, 0.2),
        ("up conv3", TB, 16000, 24, 24, 27, 0.2),
        ("up3 conv2", TB, 3200, 48, 48, 9, 0.2),
        ("up2 conv1", TB, 800, 96, 96, 3, 0.2),
        ("up1 up_conv", TB, 200, 192, 192, 1, 0.2),
        ("up1 conv_first", TB, 100, 144, 192, 1, None)]
FUSED = [("train down conv1", TB, 16000, 1, 24, 1, 0.2),
         ("train up conv3", TB, 16000, 24, 24, 27, 0.2),
         ("train up3 conv2", TB, 3200, 48, 48, 9, 0.2),
         ("train up2 conv1", TB, 800, 96, 96, 3, 0.2),
         ("decode down conv1", B, 64000, 1, 24, 1, 0.2),
         ("decode up1 conv_first", B, 400, 144, 192, 1, None),
         ("tacotron2 bap conv1", 4, 400, 86, 43, 2, None)]


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


def queued_ms(fn, iters=20, spin_cycles=50_000_000):
    """Device ms per call: `iters` calls enqueued behind a spin kernel that
    holds the stream until the host has enqueued them all, timed with CUDA
    events (the host's cost of a call left out). Raises if the host took
    longer to enqueue than the spin lasted."""
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


def device_ms(fn, n=5):
    """Device ms per call of each kernel `fn` launches, by kernel name
    (torch.profiler; a breakdown only: in a long process the profiler has
    been seen to drop a small session's kernel records)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0 and e.cpu_time_total == 0:
            out[e.key] = out.get(e.key, 0.0) + us / 1e3 / n
    return out


def short(kernel_name):
    """A profiler kernel name without its namespace and arguments."""
    name = kernel_name.replace("(anonymous namespace)::", "").split("(")[0]
    return re.sub(r"<.*>", "", name).split()[-1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--out", default=".", help="directory for the JSON")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    from svcc23_fastsvc_tpu_torch.ops import _build
    from svcc23_fastsvc_tpu_torch.ops.fused_conv import fused_conv1d
    from svcc23_fastsvc_tpu_torch.ops.window_conv import (
        window_conv,
        window_conv_dx,
        window_conv_wgrad,
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
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def run(kernel, what, shape, dtype, fn):
        by_kernel = device_ms(fn)
        row = {"kernel": kernel, "what": what, "shape": shape,
               "dtype": str(dtype)[6:], "ms": event_ms(fn),
               "device_ms": queued_ms(fn), "by_kernel": by_kernel}
        rows.append(row)
        print(f"[{args.label}] {kernel} {row['dtype']} {what} {shape}: "
              f"{row['ms']:.4f} ms, device {row['device_ms']:.4f} ms; "
              "profiler (" +
              ", ".join(f"{short(k)} {v:.4f}" for k, v in by_kernel.items())
              + ")", flush=True)

    for dtype in (torch.float32, torch.bfloat16):
        for what, nb, T, cin, cout, dil, slope in FWD + GRAD + FUSED:
            x = torch.randn((nb, T, cin), generator=gen, device=dev).to(dtype)
            g = torch.randn((nb, T, cout), generator=gen, device=dev).to(dtype)
            w = (torch.randn((3, cin, cout), generator=gen, device=dev)
                 / (3 * cin) ** 0.5).to(dtype)
            b = (torch.randn((cout,), generator=gen, device=dev) * 0.1).to(
                dtype)
            shape = f"({nb},{T},{cin})->{cout} d={dil}"
            if (what, nb, T, cin, cout, dil, slope) in FWD:
                run("window_conv", what, shape, dtype,
                    lambda: window_conv(x, w, b, dil, slope))
            elif (what, nb, T, cin, cout, dil, slope) in GRAD:
                run("window_conv_dx", what, shape, dtype,
                    lambda: window_conv_dx(g, w, dil, x, slope))
                run("window_conv_wgrad", what, shape, dtype,
                    lambda: window_conv_wgrad(x, g, 3, dil, slope))
            else:
                run("fused_conv1d", what, shape, dtype,
                    lambda: fused_conv1d(x, w, b, dil, dil, dil, slope))
            del x, g, w, b
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out,
                           f"window_conv_ab_{args.label}.json"), "w") as f:
        json.dump({"label": args.label, "root": args.root, "card": smi,
                   "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
