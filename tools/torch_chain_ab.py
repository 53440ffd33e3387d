#!/usr/bin/env python3
"""Time the port's fused chains, #9 (`pd_fixed_chain`) and #7
(`down_chain_fwd`), beside the launches each replaces, and the batches of
the paths that run them, at chip_smoke.py's shapes, from the checkout at
--root.

    python3 tools/torch_chain_ab.py --root . --label change --out DIR
    python3 tools/torch_chain_ab.py --root PARENT --label parent --out DIR

Run it on a CUDA machine for two checkouts in turns (parent, change,
change, parent) to compare two versions on one card. Rows:

- #9 at 8 x 24000, R 64, G 128, A 62, dilations (1, 1, 1, 1, 1) and
  (1, 2, 4, 8, 16), f32 and bf16, and the five `pd_fixed_block` launches it
  replaces;
- #7 on the decode batch's four DownsampleBlocks (8 x 4 s at 16 kHz) of the
  recipe's generator, f32 and bf16, and the three window convs and the
  residual it replaces (`DownsampleBlock.unfused`);
- the B02 vocoder batch (8 x 1 s) with FASTSVC_PD_CHAIN unset and 5, and
  the FastSVC decode batch (8 x 400 frames) with the down-chain mode off
  and on.

Each kernel row gets the device time per call (device_ms: 20 calls queued
behind a spin kernel, CUDA events). The batch rows of a path come in pairs,
the switch off and on, measured in 10 turns whose order alternates (the
host's speed drifts within a process, so a fixed order would favour one
side): each turn times 3 batches by CUDA events as the host issues them,
and a row keeps the median, every turn's time and, for the switch on, the
turns it won. Random weights from a seed. The
rows go to stdout and, as JSON, to DIR/chain_ab_<label>.json. Imports
torch, numpy and the package at --root only.
"""

import argparse
import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

VB, VT, VHOP, VSR = 8, 24000, 160, 24000
R, G, A = 64, 128, 62
CHAIN_DILATIONS = [(1, 1, 1, 1, 1), (1, 2, 4, 8, 16)]
B, TF, HOP, SR = 8, 400, 160, 16000
# (what, T after the block's downsample, block index): the decode batch's
DOWN_BLOCKS = [("block 0 (1->24)", 64000, 0), ("block 1 (24->48)", 12800, 1),
               ("block 2 (48->96)", 3200, 2), ("block 3 (96->192)", 800, 3)]
VOC_CONFIG = {
    "sampling_rate": VSR, "hop_size": VHOP, "aux_context_window": 2,
    "dense_factor": 4,
    "generator_params": {"upsample_params": {"upsample_scales": [5, 4, 4, 2]},
                         "aux_channels": A},
    "signal_generator": {"sine_amp": 0.1, "noise_amp": 0.003,
                         "signal_types": ["sine", "noise"]},
}
CONFIG = {
    "sampling_rate": SR, "hop_size": HOP,
    "generator_params": {"in_channels": 144, "out_channels": 1,
                         "mid_channels": [192, 96, 48, 24],
                         "upsampling_scales": [2, 4, 4, 5],
                         "spk_emb_size": 512, "use_spk_emb": True},
    "signal_generator": {"sine_amp": 0.1, "noise_amp": 0.003,
                         "sine_f0_type": "f0", "signal_types": ["sine"]},
}


def event_ms(fn, iters=5, warmup=2):
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


def fixed_params(rng, dtype, dev):
    """Random fixed-block weights as the vocoder passes them: WIO views of
    torch-layout (O, I, K) parameters."""
    def conv(K, cin, cout, bias=True):
        w = torch.from_numpy((rng.standard_normal((cout, cin, K))
                              / np.sqrt(K * cin)).astype(np.float32))
        p = {"w": w.to(dev, dtype).permute(2, 1, 0)}
        if bias:
            p["b"] = torch.from_numpy((0.1 * rng.standard_normal(cout))
                                      .astype(np.float32)).to(dev, dtype)
        return p
    return {"conv": conv(3, R, G), "aux": conv(1, A, G, bias=False),
            "out": conv(1, G // 2, R)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--out", default=".", help="directory for the JSON")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    from svcc23_fastsvc_tpu_torch.bin.decode_fastsvc import synthesize
    from svcc23_fastsvc_tpu_torch.bin.synthesize_b02 import (
        signal_generator,
        vocode,
    )
    from svcc23_fastsvc_tpu_torch.config import (
        build_generator,
        build_signal_generator,
        build_vocoder,
    )
    from svcc23_fastsvc_tpu_torch.dsp.f0 import dilated_factor
    from svcc23_fastsvc_tpu_torch.ops import _build
    from svcc23_fastsvc_tpu_torch.ops.down_chain import (
        down_chain_fwd,
        set_down_chain_mode,
    )
    from svcc23_fastsvc_tpu_torch.ops.pd_block import (
        pd_fixed_block,
        pd_fixed_chain,
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
               "device_ms": queued_ms(fn)}
        rows.append(row)
        print(f"[{args.label}] {kernel} {row['dtype']} {what}: device "
              f"{row['device_ms']:.4f} ms", flush=True)

    def batches(what, dtype, fn, switch, values, turns=10):
        """fn's batch with `switch(v)` for v in `values` (off, on), in
        turns of alternating order; one row a value."""
        runs = {v: [] for v in values}
        for v in values:
            switch(v)
            event_ms(fn, iters=1, warmup=2)
        for turn in range(turns):
            for v in (values if turn % 2 == 0 else values[::-1]):
                switch(v)
                runs[v].append(event_ms(fn, iters=3, warmup=1))
        switch(values[0])
        off, on = (runs[v] for v in values)
        for v in values:
            row = {"kernel": "batch", "what": f"{what}, {v}",
                   "dtype": str(dtype)[6:],
                   "batch_ms": sorted(runs[v])[turns // 2], "runs": runs[v]}
            if v == values[1]:
                row["turns_won"] = sum(b < a for a, b in zip(off, on))
            rows.append(row)
            print(f"[{args.label}] batch {row['dtype']} {row['what']}: "
                  f"median {row['batch_ms']:.3f} ms of {turns} turns "
                  f"[{min(runs[v]):.3f}..{max(runs[v]):.3f}]"
                  + (f", won {row['turns_won']}" if v == values[1] else ""),
                  flush=True)

    # #9 and the five block launches it replaces
    r = np.random.default_rng(12)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(r.standard_normal((VB, VT, R)).astype(
            np.float32)).to(dev, dtype)
        c = torch.from_numpy(r.standard_normal((VB, VT, A)).astype(
            np.float32)).to(dev, dtype)
        for dils in CHAIN_DILATIONS:
            params = [fixed_params(np.random.default_rng(40 + j), dtype, dev)
                      for j in range(len(dils))]

            def blocks(params=params, dils=dils):
                y = x
                for p, d in zip(params, dils):
                    y = pd_fixed_block(y, c, p, dilation=d)
                return y
            what = f"({VB},{VT},{R}|{A})->{R} d={','.join(map(str, dils))}"
            run("pd_fixed_chain", what, dtype,
                lambda params=params, dils=dils: pd_fixed_chain(
                    x, c, params, dilations=dils))
            run("5 x pd_fixed_block", what, dtype, blocks)
        del x, c

    # #7 and the window convs and residual it replaces, on the recipe
    # generator's sine-chain blocks
    gen = torch.Generator(device=dev).manual_seed(0)
    g32 = build_generator(CONFIG, device=dev, generator=gen)
    g32.fold_weight_norm_().eval()
    g16 = copy.deepcopy(g32).to(torch.bfloat16)
    gens = {torch.float32: g32, torch.bfloat16: g16}
    for dtype, g in gens.items():
        for what, T, i in DOWN_BLOCKS:
            blk = g.downsampling_sine[i]
            params = blk.block_params()
            x = torch.randn((B, T, blk.in_channels), generator=gen,
                            device=dev).to(dtype)
            shape = f"{what} ({B},{T},{blk.in_channels})->{blk.mid_channels}"
            with torch.inference_mode():
                run("down_chain_fwd", shape, dtype,
                    lambda: down_chain_fwd(x, params))
                run("3 x window_conv + residual", shape, dtype,
                    lambda: blk.unfused(x))
            del x

    # the paths' batches
    frames = VT // VHOP
    f0 = np.where(r.random((VB, frames)) > 0.2,
                  r.uniform(80, 400, (VB, frames)), 0.0).astype(np.float32)
    df = np.stack([np.repeat(dilated_factor(f, VSR, 4), VHOP) for f in f0])
    df_d = torch.from_numpy(df.astype(np.float32)).to(dev)
    init = torch.Generator().manual_seed(11)
    v32 = build_vocoder(VOC_CONFIG, generator=init).fold_weight_norm_()
    v32 = v32.to(dev).eval()
    sg = signal_generator(VOC_CONFIG)
    aux = torch.from_numpy(r.standard_normal((VB, frames + 4, A)).astype(
        np.float32)).to(dev)
    f0_d = torch.from_numpy(f0[:, :, None]).to(dev)
    rng = torch.Generator(device=dev).manual_seed(14)
    saved = os.environ.get("FASTSVC_PD_CHAIN")

    def chain_env(value):
        if value is None:
            os.environ.pop("FASTSVC_PD_CHAIN", None)
        else:
            os.environ["FASTSVC_PD_CHAIN"] = value
    for dtype in (torch.float32, torch.bfloat16):
        voc = v32.to(dtype)
        batches(f"vocoder {VB} x 1 s, FASTSVC_PD_CHAIN", dtype,
                lambda voc=voc: vocode(voc, sg, f0_d, aux, df_d,
                                       generator_rng=rng),
                chain_env, (None, "5"))
    chain_env(saved)
    sgf = build_signal_generator(CONFIG)
    ppg = torch.randn((B, TF, 144), generator=gen, device=dev)
    lft = 0.1 * torch.randn((B, TF * HOP, 1), generator=gen, device=dev)
    emb = torch.randn((B, 512), generator=gen, device=dev)
    f0f = torch.where(torch.rand((B, TF), generator=gen, device=dev) > 0.2,
                      80 + 320 * torch.rand((B, TF), generator=gen,
                                            device=dev),
                      torch.zeros((B, TF), device=dev))[:, :, None]
    for dtype, g in gens.items():
        try:
            batches(f"decode {B} x 4 s, down chain", dtype,
                    lambda g=g: synthesize(g, sgf, ppg, f0f, lft, emb,
                                           generator_rng=rng),
                    set_down_chain_mode, ("0", "1"))
        finally:
            set_down_chain_mode("0")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"chain_ab_{args.label}.json"),
              "w") as f:
        json.dump({"label": args.label, "gpu": smi, "rows": rows}, f,
                  indent=1)


if __name__ == "__main__":
    main()
