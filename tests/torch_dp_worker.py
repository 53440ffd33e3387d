"""One rank of the data-parallel runs in test_torch_parallel.py.

Started by `torch.multiprocessing` (spawn), so it imports torch and the
port only, never JAX. `run` joins the ranks over gloo through the port's
`parallel.initialize`, runs every case on this rank's rows of the global
batches the test wrote to `workdir/inputs.pt` (from the weights it wrote
there) and saves what each case gives to `workdir/rank{r}.pt`.
"""

import os

import numpy as np
import torch

from svcc23_fastsvc_tpu_torch.data.wire import to_device
from svcc23_fastsvc_tpu_torch.losses import MultiResolutionSTFTLoss
from svcc23_fastsvc_tpu_torch.models import tacotron2 as tt
from svcc23_fastsvc_tpu_torch.models.fastsvc import (
    FastSVCGenerator,
    MelGANMultiScaleDiscriminator,
)
from svcc23_fastsvc_tpu_torch.ops import conv as tconv
from svcc23_fastsvc_tpu_torch.ops import fused_conv
from svcc23_fastsvc_tpu_torch.ops.signal_gen import SignalGenerator
from svcc23_fastsvc_tpu_torch.parallel import (
    initialize,
    jit_multi_step_dp,
    jit_train_step_dp,
    make_mesh,
    shard_batch,
    shard_map_forward_dp,
    shard_stacked_batch,
)
from svcc23_fastsvc_tpu_torch.train.b02 import B02TrainTask
from svcc23_fastsvc_tpu_torch.train.gan import FastSVCTrainTask
from svcc23_fastsvc_tpu_torch.train.state import RefRAdam

# the FastSVC case: test_torch_train.py's widths
GEN = dict(in_channels=8, mid_channels=(16, 8), upsampling_scales=(4, 5),
           spk_emb_size=12)
DIS = dict(scales=2, channels=4, max_downsample_channels=32,
           downsample_scales=(4, 4))
STFT = ((64, 128), (16, 32), (64, 128))
SR, HOP = 4000, 20
# the B02 case: test_torch_b02_train.py's widths, dropout off
B02_SMALL = dict(input_dim=16, output_dim=60, hidden_dim=32, dec_layers=2,
                 spk_emb_dim=8, econv_chans=16, prenet_dim=8,
                 enc_dropout_rate=0.0, dec_dropout_rate=0.0,
                 prenet_dropout_rate=0.0)
B02_T = 24
K = 3  # the K-step case


def fastsvc_task(weights: dict, dp_group=None) -> FastSVCTrainTask:
    gen = FastSVCGenerator(**GEN)
    gen.load_state_dict(weights["g"])
    dis = MelGANMultiScaleDiscriminator(**DIS)
    dis.load_state_dict(weights["d"])
    return FastSVCTrainTask(
        generator=gen, discriminator=dis,
        g_opt=RefRAdam(gen.parameters(), lr=1e-3, grad_norm=10.0),
        d_opt=RefRAdam(dis.parameters(), lr=1e-3, grad_norm=1.0),
        signal_generator=SignalGenerator(sample_rate=SR, hop_size=HOP),
        stft_loss=MultiResolutionSTFTLoss(*STFT),
        rng=torch.Generator().manual_seed(0), dp_group=dp_group)


def b02_task(weights: dict, dp_group=None) -> B02TrainTask:
    gen = tt.Tacotron2(**B02_SMALL)
    gen.load_state_dict(weights["g"])
    dis = tt.MultiSubFreqDiscriminator(batch_max_frames=B02_T)
    dis.load_state_dict(weights["d"])
    return B02TrainTask(
        generator=gen, discriminator=dis,
        g_opt=RefRAdam(gen.parameters(), lr=1e-3, grad_norm=1.0),
        d_opt=RefRAdam(dis.parameters(), lr=1e-3, grad_norm=1.0),
        rng=torch.Generator().manual_seed(0), dp_group=dp_group)


def state(task) -> dict:
    return {"g": {k: v.clone() for k, v in
                  task.generator.state_dict().items()},
            "d": {k: v.clone() for k, v in
                  task.discriminator.state_dict().items()}}


def run(rank: int, world: int, port: int, workdir: str):
    torch.set_num_threads(1)
    initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    mesh = make_mesh(world)
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    out = {}

    def rows(batch):
        return shard_batch(batch, mesh, device="cpu")

    # gen_step then gan_step, as one process runs them on the global batch
    task = fastsvc_task(inp["fastsvc"])
    out["metrics"] = [
        jit_train_step_dp(task.gen_step, mesh)(rows(inp["batches"][0])),
        jit_train_step_dp(task.gan_step, mesh)(rows(inp["batches"][1]))]
    out["fastsvc"] = state(task)

    # one K-step call against K data-parallel steps
    stacked = {k: np.stack([b[k] for b in inp["k_batches"]])
               for k in inp["k_batches"][0]}
    multi = fastsvc_task(inp["fastsvc"])
    out["k_metrics"] = jit_multi_step_dp(multi.gan_step, mesh)(
        shard_stacked_batch(stacked, mesh, device="cpu"))
    out["k_call"] = state(multi)
    seq = fastsvc_task(inp["fastsvc"])
    step = jit_train_step_dp(seq.gan_step, mesh)
    out["k_seq_metrics"] = [step(rows(b)) for b in inp["k_batches"]]
    out["k_seq"] = state(seq)

    # the fused-conv switch off and on, counting the fused conv's calls
    saved = tconv.pallas_conv_mode(), fused_conv.fused_conv1d_plain
    calls = {"n": 0}

    def counted(*args, **kw):
        calls["n"] += 1
        return saved[1](*args, **kw)

    out["fused_calls"] = {}
    fused_conv.fused_conv1d_plain = counted
    try:
        for mode in ("0", "1"):
            tconv.set_pallas_conv_mode(mode)
            calls["n"] = 0
            t = fastsvc_task(inp["fastsvc"])
            out[f"conv{mode}_metrics"] = jit_train_step_dp(t.gan_step, mesh)(
                rows(inp["long_batch"]))
            out[f"conv{mode}"] = state(t)
            out["fused_calls"][mode] = calls["n"]
    finally:
        tconv.set_pallas_conv_mode(saved[0])
        fused_conv.fused_conv1d_plain = saved[1]

    # B02: lengths that differ across the ranks
    b02 = b02_task(inp["b02"])
    out["b02_metrics"] = jit_train_step_dp(b02.gen_step, mesh)(
        rows(inp["b02_batch"]))
    out["b02"] = state(b02)

    # data-parallel inference: every rank gets the whole batch's output
    fwd = fastsvc_task(inp["fastsvc"]).generator
    b = to_device(inp["batches"][0], "cpu")
    with torch.no_grad():
        out["forward"] = shard_map_forward_dp(fwd, mesh)(
            b["ppg"], b["sine"], b["lft"], b["spk_emb"])
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
