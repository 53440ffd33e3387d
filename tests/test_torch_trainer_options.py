"""The port's `Trainer` options against the JAX package's `Trainer`, on
the CPU.

- `generator_train_start_steps` > 0: the warm-up fast-forward to
  min(g_start, d_start) + 1, one and three steps a call. The calls each
  trainer makes, their per-call metric means and the final weights are
  held as in test_torch_trainer_trajectory.py; the step count, the
  checkpoint it names, and the optimizers' counts (RAdam's step and the
  StepLR epoch, which do not jump, in either package) agree.
- Intermediate dumps (`num_save_intermediate_results`) after eval: the
  wav pairs and pngs under predictions/step{N}/, in f32 and bf16, the
  generated wav that of the task's eager `predict` seeded by the step;
  without matplotlib the wavs are still written.
- Scalars to a tensorboard writer under train/ and eval/, and
  `bin.common.summary_writer` with and without tensorboardX.
- `profile_dir`: a torch.profiler trace of the run is written.

Sizes are test_torch_train.py's (two narrow blocks, 200-sample crops).
"""

import json
import os
import sys

import jax
import numpy as np
import optax
import pytest
import torch
from scipy.io import wavfile

from svcc23_fastsvc_tpu.train.checkpoint import latest_step
from svcc23_fastsvc_tpu.train.loop import Trainer as JaxTrainer
from svcc23_fastsvc_tpu_torch.bin.common import summary_writer, write_wav
from svcc23_fastsvc_tpu_torch.compat import (
    generator_state_dict_from_jax,
    melgan_msd_state_dict_from_jax,
)
from svcc23_fastsvc_tpu_torch.config import build_train_task
from svcc23_fastsvc_tpu_torch.data.collate import FastSVCBatcher
from svcc23_fastsvc_tpu_torch.data.wire import to_device
from svcc23_fastsvc_tpu_torch.train.checkpoint import latest_checkpoint
from svcc23_fastsvc_tpu_torch.train.loop import Trainer
from test_torch_train import HOP, _batch, _tasks, _utterances
from test_torch_train_multi_step import CFG
from test_torch_trainer_trajectory import ListBatches, _check

STEPS, D_START, G_START = 12, 6, 4


def _counts(opt_state):
    return {int(v) for _, v in optax.tree_utils.tree_get_all_with_path(
        opt_state, "count")}


@pytest.mark.parametrize("k", [1, 3])
def test_generator_start_fast_forward_tracks_the_jax_trainer(tmp_path, k):
    jtask, state, task = _tasks(None)
    start = (generator_state_dict_from_jax(
        jax.tree.map(np.asarray, state.g_params)),
        melgan_msd_state_dict_from_jax(
            jax.tree.map(np.asarray, state.d_params)))
    batches = [_batch(300 + i) for i in range(STEPS)]
    cfg = {"train_max_steps": STEPS, "discriminator_train_start_steps":
           D_START, "generator_train_start_steps": G_START,
           "log_interval_steps": 100, "eval_interval_steps": 100,
           "save_interval_steps": 100, "batch_size": 2,
           "batch_length": 200, "sampling_rate": 4000, "hop_size": HOP,
           "steps_per_call": k}
    jt = JaxTrainer(jtask, state, ListBatches(batches), config=cfg,
                    outdir=str(tmp_path / "jax"))
    j_means, j_calls = [], []
    jt._accumulate = lambda m: j_means.append(
        {n: float(np.asarray(v)) for n, v in jax.device_get(m).items()})
    for name in ("_gen_step", "_gan_step", "_gen_multi", "_gan_multi"):
        fn = getattr(jt, name, None)
        if fn is not None:
            def recorded(s, b, fn=fn, name=name):
                j_calls.append(1 if "step" in name
                               else int(b["audio"].shape[0]))
                return fn(s, b)
            setattr(jt, name, recorded)
    jstate = jt.run()
    port_batches = ListBatches(batches)
    pt = Trainer(task, port_batches, config=cfg, outdir=str(tmp_path / "pt"))
    p_means = []
    pt._accumulate = lambda m: p_means.append(
        {n: float(v) for n, v in m.items()})
    pt.run()
    # steps 1-5 skipped (the count jumps to 5): steps 6 and 7 are gen
    # steps, 8-12 gan steps
    want_calls = [1] * 7 if k == 1 else [2, 3, 2]
    assert pt.call_sizes == j_calls == want_calls
    assert task.step == int(jstate.step) == STEPS
    assert latest_step(str(tmp_path / "jax")) == STEPS
    assert latest_checkpoint(str(tmp_path / "pt")).endswith(
        f"checkpoint-{STEPS}steps.pkl")
    assert (task.g_opt.count, task.d_opt.count) == (7, 5)
    assert _counts(jstate.g_opt_state) == {7}
    assert _counts(jstate.d_opt_state) == {5}
    weights = (
        (task.generator.state_dict(), generator_state_dict_from_jax(
            jax.tree.map(np.asarray, jstate.g_params))),
        (task.discriminator.state_dict(), melgan_msd_state_dict_from_jax(
            jax.tree.map(np.asarray, jstate.d_params))))
    _check(j_means, p_means, weights, start)


def _batcher(seed):
    return FastSVCBatcher(_utterances(), batch_size=2, batch_length=200,
                          hop_size=HOP, seed=seed)


def _trainer(outdir, *, compute_dtype=None, writer=None, **over):
    cfg = {**CFG, "train_max_steps": 2, "discriminator_train_start_steps": 10,
           "log_interval_steps": 1, "eval_interval_steps": 2,
           "save_interval_steps": 100, "eval_batches": 1, **over}
    if compute_dtype:
        cfg["compute_dtype"] = compute_dtype
    task = build_train_task(cfg, device="cpu", seed=3)
    return Trainer(task, _batcher(4), config=cfg, outdir=str(outdir),
                   dev_batcher=_batcher(5), writer=writer)


@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["f32", "bf16"])
def test_intermediate_dumps_are_the_eager_forward(tmp_path, dtype):
    t = _trainer(tmp_path, compute_dtype=dtype,
                 num_save_intermediate_results=2)
    t.run()
    pred = tmp_path / "predictions" / "step2"
    assert sorted(os.listdir(pred)) == ["0.png", "0_gen.wav", "0_ref.wav",
                                        "1.png", "1_gen.wav", "1_ref.wav"]
    dev = _batcher(5)
    dev.sample_batch()  # the eval's batch; the dump takes the next one
    batch = dev.sample_batch()
    y = t.task.predict(to_device(batch, "cpu"), seed=2)
    assert y.dtype == torch.float32 and torch.isfinite(y).all()
    for i in range(2):
        write_wav(str(tmp_path / "want.wav"), y[i, :, 0].numpy(), 4000)
        sr, got = wavfile.read(pred / f"{i}_gen.wav")
        assert sr == 4000 and got.shape == (200,)
        np.testing.assert_array_equal(
            got, wavfile.read(tmp_path / "want.wav")[1])
        write_wav(str(tmp_path / "want.wav"), batch["audio"][i, :, 0], 4000)
        np.testing.assert_array_equal(
            wavfile.read(pred / f"{i}_ref.wav")[1],
            wavfile.read(tmp_path / "want.wav")[1])
        assert (pred / f"{i}.png").stat().st_size > 1000


def test_dumps_without_matplotlib_still_write_the_wavs(tmp_path,
                                                       monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    _trainer(tmp_path, num_save_intermediate_results=1).run()
    assert sorted(os.listdir(tmp_path / "predictions" / "step2")) == [
        "0_gen.wav", "0_ref.wav"]


class _Writer:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, step))


def test_scalars_go_to_the_writer_and_summary_writer_is_optional(
        tmp_path, monkeypatch):
    w = _Writer()
    _trainer(tmp_path, writer=w).run()
    tags = {t for t, _ in w.scalars}
    assert {"train/generator_loss", "train/steps_per_s",
            "train/data_wait_s", "eval/generator_loss"} <= tags
    assert {s for t, s in w.scalars if t.startswith("train/")} == {1, 2}
    assert {s for t, s in w.scalars if t.startswith("eval/")} == {2}
    real = summary_writer(str(tmp_path / "tb"))
    assert real is not None and hasattr(real, "add_scalar")
    real.close()
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    assert summary_writer(str(tmp_path / "tb2")) is None


def test_profile_dir_writes_a_trace(tmp_path):
    prof = tmp_path / "prof"
    _trainer(tmp_path, profile_dir=str(prof)).run()
    trace = prof / "trace-step0.json"
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    assert any("autograd" in str(e.get("name", "")) or
               "aten::" in str(e.get("name", "")) for e in events)
