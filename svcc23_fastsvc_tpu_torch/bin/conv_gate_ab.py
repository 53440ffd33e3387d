#!/usr/bin/env python3
"""Time the recipe's captured K-step gan call with the window-conv width
gate (`ops.conv.WINDOW_CONV_MAX_CHANNELS`) at two values, in one process.

    python3 -m svcc23_fastsvc_tpu_torch.bin.conv_gate_ab [--gates 384 1024]

The gate decides which stride-1 "same" convs run on the window-conv
kernels (#2-#4) and which on cuDNN; a captured graph bakes the choice in.
For each dtype of the recipe (bf16 with the packed wire, then f32) and
each gate in turns (a, b, b, a, a, b), this builds the task of
egs/svcc23/fastsvc1/conf/fastsvc.yaml at full width (weights from a seed),
captures its gan call of `steps_per_call` steps on one stacked batch of
random crops (32 x 16000 samples, 144-d ppg) and reads the median of five
replays' CUDA event times, per step. cuDNN runs its deterministic
algorithms and TF32 is off, as the training CLI sets them. The rows go to
stdout and, as one JSON object, to --out/conv_gate_ab.json when --out is
given. Needs a CUDA device.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RECIPE = os.path.join(ROOT, "egs", "svcc23", "fastsvc1", "conf",
                      "fastsvc.yaml")


def items(n=24, seed=0, hop=160, sr=16000):
    """Utterances in FastSVCDataset's item layout, 2.5-4 s each."""
    r = np.random.default_rng(seed)
    out = []
    for j in range(n):
        nf = int(r.integers(250, 400))
        t = np.arange(nf * hop) / sr
        wave = 0.3 * np.sin(2 * np.pi * r.uniform(100, 400) * t)
        out.append((f"utt{j}", wave.astype(np.float32),
                    np.where(r.random(nf) > 0.2, r.uniform(80, 400, nf),
                             0.0).astype(np.float32),
                    r.standard_normal((nf, 144)).astype(np.float32),
                    np.repeat(0.1 * r.standard_normal(nf), hop).astype(
                        np.float32),
                    r.standard_normal((1, 512)).astype(np.float32)))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--gates", type=int, nargs=2, default=(384, 1024))
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("conv_gate_ab needs a CUDA device")
    sys.path.insert(0, ROOT)
    from svcc23_fastsvc_tpu_torch.bin.common import (
        deterministic_cudnn,
        disable_tf32,
    )
    from svcc23_fastsvc_tpu_torch.config import build_train_task, load_config
    from svcc23_fastsvc_tpu_torch.data.collate import FastSVCBatcher
    from svcc23_fastsvc_tpu_torch.data.wire import WirePacker
    from svcc23_fastsvc_tpu_torch.ops import conv
    from svcc23_fastsvc_tpu_torch.train.graphs import StepGraphs
    from svcc23_fastsvc_tpu_torch.train.loop import _stack

    disable_tf32()
    deterministic_cudnn()
    dev = torch.device("cuda")
    recipe = load_config(RECIPE)
    k = int(recipe["steps_per_call"])
    batcher = FastSVCBatcher(items(), batch_size=recipe["batch_size"],
                             batch_length=recipe["batch_length"],
                             hop_size=recipe["hop_size"], seed=2)
    a, b = args.gates
    res = {}
    for dt, wire in (("bfloat16", "packed"), ("float32", "f32")):
        cfg = {**recipe, "compute_dtype": dt, "wire_format": wire}
        pack = (WirePacker(hop_size=cfg["hop_size"]) if wire == "packed"
                else (lambda x: x))
        stacked = pack(_stack([batcher.sample_batch() for _ in range(k)]))
        for gate in (a, b, b, a, a, b):
            conv.WINDOW_CONV_MAX_CHANNELS = gate
            task = build_train_task(cfg, device=dev, seed=7)
            graphs = StepGraphs(task)
            graphs.replay(graphs.stage("gan", stacked))
            graph = next(iter(graphs.graphs.values())).graph
            times = []
            for _ in range(5):
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
                graph.replay()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / k)
            ms = sorted(times)[2]
            res.setdefault(f"{dt} gate {gate}", []).append(ms)
            print(f"{dt} gate {gate}: {ms:.4f} ms a step (median of 5 "
                  f"replays of a {k}-step gan call)", flush=True)
            del task, graphs, graph
            torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "conv_gate_ab.json"), "w") as f:
            json.dump({"device": torch.cuda.get_device_name(0), **res}, f)


if __name__ == "__main__":
    main()
