"""The port's K steps a call (`steps_per_call`) on the CPU.

- `FastSVCTrainTask.multi_step` (three gen steps, then three gan steps)
  against JAX `jax.jit(make_multi_step(task.{phase}_step))` on the same
  stacked batches, f32 and bf16, with test_torch_train.py's tolerances
  where six steps keep within them (see STEP_TOL and G_RECTIFIED_L2).
- `RefRAdam.step` with its scalars as a device tensor (`coefficients`, as
  a captured step reads them) against the host-float path, bit for bit
  over 12 steps that cross the switch to the rectified update (step 5)
  and a StepLR boundary (step 10), clipping on and off.
- The port's `Trainer` with `steps_per_call: 4` against `steps_per_call:
  1`: the same weights, optimizer state and noise state bit for bit, the
  calls split at the intervals and the phase switch, `train_max_steps`
  reached exactly and saved; a `resume` after a K-step run goes on bit
  for bit.

The sizes are test_torch_train.py's (two narrow blocks, 200-sample crops).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svcc23_fastsvc_tpu.train.gan import make_multi_step
from svcc23_fastsvc_tpu_torch.compat import (
    generator_state_dict_from_jax,
    melgan_msd_state_dict_from_jax,
)
from svcc23_fastsvc_tpu_torch.config import build_train_task
from svcc23_fastsvc_tpu_torch.data.collate import FastSVCBatcher
from svcc23_fastsvc_tpu_torch.data.wire import to_device
from svcc23_fastsvc_tpu_torch.train.checkpoint import latest_checkpoint
from svcc23_fastsvc_tpu_torch.train.loop import Trainer
from svcc23_fastsvc_tpu_torch.train.state import RefRAdam
from test_torch_train import (
    DIS,
    GEN,
    HOP,
    LOSS_TOL,
    SR,
    STFT,
    _batch,
    _flat,
    _rel_err,
    _tasks,
    _utterances,
)

K = 3


def _stacked(seed0):
    bs = [_batch(seed0 + i) for i in range(K)]
    return {k: np.stack([b[k] for b in bs]) for k in bs[0]}


def _check_weights(port_sd, start, jparams, dtype, *, per_tensor=True,
                   l2_tol=0.3):
    """test_gen_then_gan_step_match_jax's bounds: in f32 each tensor within
    2e-3 of how far JAX moved it (+ 4e-7 of the weight), else (bf16, or
    `per_tensor` False) the relative L2 distance of the whole update."""
    assert set(port_sd) == set(jparams)
    for k, v in port_sd.items():
        assert torch.isfinite(v).all(), k
        if dtype is None and per_tensor:
            moved = (jparams[k] - start[k]).abs().max().item()
            err = (v - jparams[k]).abs().max().item()
            assert err <= 2e-3 * moved + 4e-7 * v.abs().max().item(), k
    if dtype is not None or not per_tensor:
        keys = sorted(port_sd)
        u_port = _flat(port_sd, keys) - _flat(start, keys)
        u_jax = _flat(jparams, keys) - _flat(start, keys)
        assert ((u_port - u_jax).norm() / u_jax.norm()).item() < l2_tol


# Per-step metrics: test_torch_train.py's LOSS_TOL in f32. In bf16 the
# frameworks round in different places and the trajectories part: over
# these six steps the worst metric (the spectral convergence loss of the
# first gan step) is 1.48e-2 from JAX's (measured on the CPU). It was
# 3.25e-2 while the port rounded the generator's output to bf16 before the
# f32 losses; XLA keeps the last conv's f32 sums there (`f32_out` of
# FastSVCGenerator.forward). Held at twice what was measured.
STEP_TOL = {None: LOSS_TOL[None], torch.bfloat16: 3.0e-2}

# G's update after the six steps in f32: RAdam's rectified steps (5 and 6)
# move a tensor by about lr whatever its gradient's size, so where the
# gradient is mostly rounding (the FiLM shift biases) the two frameworks
# move it apart by as much as JAX moved it: 80 of G's 127 tensors then miss
# the per-tensor bound (the FiLM shift biases by 111x), while every loss
# agrees to 5.5e-5 and G's whole update to 1.3e-3 relative L2 (measured on
# the CPU). Held at 10x that.
G_RECTIFIED_L2 = 1.3e-2


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_multi_step_matches_jax_make_multi_step(dtype):
    """Per-step metrics within STEP_TOL. The final weights within
    test_gen_then_gan_step_match_jax's bounds, but for G in f32, held by its
    whole update (G_RECTIFIED_L2) after the six steps and tensor by tensor
    after the gen call (three steps, RAdam's SGD branch)."""
    jtask, state, task = _tasks(dtype)
    g0 = {k: v.clone() for k, v in task.generator.state_dict().items()}
    d0 = {k: v.clone() for k, v in task.discriminator.state_dict().items()}
    for phase, seed0 in (("gen", 40), ("gan", 50)):
        stacked = _stacked(seed0)
        state, jm = jax.jit(make_multi_step(getattr(jtask, f"{phase}_step")))(
            state, {k: jnp.asarray(v) for k, v in stacked.items()})
        tm = task.multi_step(phase, to_device(stacked, "cpu"))
        assert set(tm) == set(jm)
        for k in jm:
            assert tuple(tm[k].shape) == (K,) == jm[k].shape
            for i in range(K):
                assert _rel_err(tm[k][i], jm[k][i]) < STEP_TOL[dtype], (
                    phase, k, i)
        jg = generator_state_dict_from_jax(
            jax.tree.map(np.asarray, state.g_params))
        if phase == "gen" and dtype is None:
            _check_weights(task.generator.state_dict(), g0, jg, dtype)
    assert task.step == 2 * K == int(state.step)
    assert task.g_opt.count == 2 * K and task.d_opt.count == K
    _check_weights(task.generator.state_dict(), g0, jg, dtype,
                   per_tensor=False,
                   l2_tol=0.3 if dtype is not None else G_RECTIFIED_L2)
    _check_weights(task.discriminator.state_dict(), d0,
                   melgan_msd_state_dict_from_jax(
                       jax.tree.map(np.asarray, state.d_params)), dtype)


@pytest.mark.parametrize("chunk", [4, 12])
@pytest.mark.parametrize("clip,wd", [(0.0, 0.0), (2.0, 0.0), (10.0, 1e-2)])
def test_radam_tensor_coefficients_give_the_float_paths_bits(chunk, clip, wd):
    """Calls of `chunk` steps, each reading its scalars from one
    `coefficients(chunk)` table, against 12 host-float steps: parameters,
    moments, counts and state dicts equal bit for bit."""
    r = np.random.default_rng(5)
    p0 = [r.standard_normal(s).astype(np.float32) for s in ((64,), (3, 5))]
    grads = [[(r.standard_normal(p.shape) * 10 ** r.uniform(-4, 1)).astype(
        np.float32) for p in p0] for _ in range(12)]
    kw = dict(lr=1e-2, eps=1e-6, weight_decay=wd, grad_norm=clip,
              scheduler_step_size=10, scheduler_gamma=0.5)
    pa = [torch.from_numpy(p.copy()) for p in p0]
    pb = [torch.from_numpy(p.copy()) for p in p0]
    host, dev = RefRAdam(pa, **kw), RefRAdam(pb, **kw)
    for g in grads:
        host.step([torch.from_numpy(a) for a in g])
    for c in range(0, 12, chunk):
        table = torch.from_numpy(dev.coefficients(chunk))
        assert table.dtype == torch.float32 and table.shape == (chunk, 4)
        for i in range(chunk):
            dev.step([torch.from_numpy(a) for a in grads[c + i]], table[i])
        dev.advance(chunk)
    assert host.count == dev.count == 12
    for a, b in zip(pa + host.mu + host.nu, pb + dev.mu + dev.nu):
        assert torch.equal(a, b)
    sa, sb = host.state_dict(), dev.state_dict()
    assert sa["scheduler"] == sb["scheduler"]
    assert sa["optimizer"]["param_groups"] == sb["optimizer"]["param_groups"]
    # both branches and both learning rates were taken
    table = RefRAdam(pa, **kw).coefficients(12)
    assert set(table[:, 1]) == {0.0, 1.0} and len(set(table[:, 0])) == 2


# -- the Trainer ----------------------------------------------------------

CFG = {
    "sampling_rate": SR, "hop_size": HOP,
    "generator_params": {**GEN, "mid_channels": list(GEN["mid_channels"]),
                         "upsampling_scales": list(GEN["upsampling_scales"])},
    "discriminator_params": {**DIS,
                             "downsample_scales": list(
                                 DIS["downsample_scales"])},
    "stft_loss_params": {"fft_sizes": list(STFT[0]),
                         "hop_sizes": list(STFT[1]),
                         "win_lengths": list(STFT[2])},
    "batch_size": 2, "batch_length": 200,
    "signal_generator": {"sine_amp": 0.1, "noise_amp": 0.003,
                         "signal_types": ["sine"]},
    "discriminator_train_start_steps": 5,
    "log_interval_steps": 4, "eval_interval_steps": 1000,
    "save_interval_steps": 6,
}


def _train(outdir, steps_per_call, max_steps, resume=None):
    cfg = {**CFG, "steps_per_call": steps_per_call,
           "train_max_steps": max_steps}
    task = build_train_task(cfg, device="cpu", seed=3)
    batcher = FastSVCBatcher(_utterances(), batch_size=2, batch_length=200,
                             hop_size=HOP, seed=4)
    trainer = Trainer(task, batcher, config=cfg, outdir=str(outdir))
    if resume:
        trainer.resume(resume)
    trainer.run()
    return trainer


def _same_state(a, b):
    for x, y in ((a.generator, b.generator),
                 (a.discriminator, b.discriminator)):
        sx, sy = x.state_dict(), y.state_dict()
        assert all(torch.equal(sx[k], sy[k]) for k in sx)
    for x, y in ((a.g_opt, b.g_opt), (a.d_opt, b.d_opt)):
        assert x.count == y.count
        assert all(torch.equal(u, v) for u, v in zip(x.mu + x.nu,
                                                     y.mu + y.nu))
    assert a.step == b.step
    assert torch.equal(a.rng.get_state(), b.rng.get_state())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("multi_step")
    return root, {k: _train(root / f"k{k}", k, 12) for k in (1, 4)}


def test_trainer_four_steps_a_call_equal_one_step_a_call(runs):
    root, by_k = runs
    one, four = by_k[1], by_k[4]
    # split at the log interval (4), the save interval (6), which is also
    # the last gen step, and the log interval again
    assert one.call_sizes == [1] * 12
    assert four.call_sizes == [4, 2, 2, 4]
    _same_state(one.task, four.task)
    assert [h["step"] for h in four.history] == [4, 8, 12]
    for h1, h4 in zip(one.history, four.history):
        for k, v in h1.items():
            if k.endswith("_loss"):
                assert h4[k] == pytest.approx(v, rel=1e-6), k
    for k in (1, 4):
        assert latest_checkpoint(str(root / f"k{k}")).endswith(
            "checkpoint-12steps.pkl")
        assert os.path.exists(root / f"k{k}" / "checkpoint-6steps.pkl")


def test_resume_after_k_step_calls_continues_bit_for_bit(runs, tmp_path):
    """Steps 1-6 in one run and 7-12 after `resume` in another, four steps
    a call: the state of 12 steps in one run."""
    root, by_k = runs
    first = _train(tmp_path / "a", 4, 6)
    assert first.call_sizes == [4, 2]
    second = _train(tmp_path / "b", 4, 12,
                    resume=str(tmp_path / "a" / "checkpoint-6steps.pkl"))
    assert second.call_sizes == [2, 4]
    _same_state(second.task, by_k[4].task)
