"""The port's `Trainer` against the JAX package's `Trainer`, step by step.

Both trainers start from the same converted weights (the JAX task's
initial state through `generator_state_dict_from_jax` and
`melgan_msd_state_dict_from_jax`), read the same precomputed batches
(`batch["sine"]` given, so neither draws excitation noise) and run 16
steps in f32 with `discriminator_train_start_steps` 6, so both phases run.
The sizes are test_torch_train.py's (two narrow blocks, 200-sample crops).

- `steps_per_call: 1`, `log_interval_steps: 1`: the losses of every step.
- `steps_per_call: 4`: the calls the two trainers make (`_next_boundary`
  splits them at the log interval and the phase switch: 4, 3, 1, 4, 4)
  and the per-call means each accumulates for its log.

Tolerance: the frameworks differ by f32 summation order only, and the
difference grows as the trajectories move apart, fastest once RAdam takes
its rectified step (step 5): m / sqrt(v) turns a gradient that is mostly
rounding into a full-size move, so some tensors (the FiLM shift biases)
end as far from JAX's as JAX moved them. The weights are held as a whole,
by the relative L2 distance of each model's update from JAX's. Measured on
the CPU, four steps a call and one step a call: losses 8.6e-5 and 5.6e-5
relative, G's update 1.0e-2 and 4.6e-3, D's 2.0e-4 and 5.0e-4. The
tolerances are 10x the larger of each pair: 8.6e-4, 0.1 and 5e-3.
"""

import numpy as np
import torch

import jax

from svcc23_fastsvc_tpu.train.loop import Trainer as JaxTrainer
from svcc23_fastsvc_tpu_torch.compat import (
    generator_state_dict_from_jax,
    melgan_msd_state_dict_from_jax,
)
from svcc23_fastsvc_tpu_torch.train.loop import Trainer
from test_torch_train import _batch, _tasks

STEPS, D_START = 16, 6
LOSS_TOL = 8.6e-4
UPDATE_TOL = {"G": 0.1, "D": 5e-3}


class ListBatches:
    """One list of batches for either trainer, which both iterate (through
    a prefetch thread); `taken` counts the batches handed out."""

    def __init__(self, batches):
        self.batches = batches
        self.taken = 0

    def __iter__(self):
        for b in self.batches:
            self.taken += 1
            yield {k: v.copy() for k, v in b.items()}


def _config(steps_per_call, log_interval):
    return {
        "train_max_steps": STEPS,
        "discriminator_train_start_steps": D_START,
        "log_interval_steps": log_interval,
        "eval_interval_steps": 1000,
        "save_interval_steps": 1000,
        "batch_size": 2,
        "batch_length": 200,
        "sampling_rate": 4000,
        "hop_size": 20,
        "steps_per_call": steps_per_call,
    }


def _run_both(tmp_path, steps_per_call, log_interval):
    """Per-call metric means and call sizes of each trainer, and the final
    weights (JAX's converted to the port's keys)."""
    jtask, state, task = _tasks(None)
    # the JAX trainer donates its state: keep the starting weights first
    start = (generator_state_dict_from_jax(
        jax.tree.map(np.asarray, state.g_params)),
        melgan_msd_state_dict_from_jax(
            jax.tree.map(np.asarray, state.d_params)))
    batches = [_batch(100 + i) for i in range(STEPS)]
    cfg = _config(steps_per_call, log_interval)

    jt = JaxTrainer(jtask, state, ListBatches(batches), config=cfg,
                    outdir=str(tmp_path / "jax"))
    j_calls, j_means = [], []
    jt._accumulate = lambda m: j_means.append(
        {k: float(np.asarray(v)) for k, v in jax.device_get(m).items()})
    for name in ("_gen_step", "_gan_step", "_gen_multi", "_gan_multi"):
        fn = getattr(jt, name, None)
        if fn is None:
            continue

        def recorded(s, b, fn=fn, name=name):
            j_calls.append((name[1:4], 1 if "step" in name
                            else int(b["audio"].shape[0])))
            return fn(s, b)
        setattr(jt, name, recorded)
    jstate = jt.run()

    port_batches = ListBatches(batches)
    pt = Trainer(task, port_batches, config=cfg, outdir=str(tmp_path / "pt"))
    p_means = []
    pt._accumulate = lambda m: p_means.append(
        {k: float(v) for k, v in m.items()})
    pt.run()
    assert port_batches.taken == STEPS
    weights = (
        (task.generator.state_dict(), generator_state_dict_from_jax(
            jax.tree.map(np.asarray, jstate.g_params))),
        (task.discriminator.state_dict(), melgan_msd_state_dict_from_jax(
            jax.tree.map(np.asarray, jstate.d_params))))
    return j_calls, j_means, pt.call_sizes, p_means, weights, start


def _check(j_means, p_means, weights, start):
    assert len(p_means) == len(j_means)
    for i, (p, j) in enumerate(zip(p_means, j_means)):
        assert set(p) == set(j), i
        for k in j:
            rel = abs(p[k] - j[k]) / max(abs(j[k]), 1e-6)
            assert rel < LOSS_TOL, (i, k, p[k], j[k])
    for who, (port_sd, jax_sd), s0 in zip("GD", weights, start):
        keys = sorted(port_sd)
        flat = lambda sd: torch.cat(  # noqa: E731
            [sd[k].reshape(-1).float() for k in keys])
        u_port, u_jax = flat(port_sd) - flat(s0), flat(jax_sd) - flat(s0)
        assert torch.isfinite(u_port).all(), who
        rel = ((u_port - u_jax).norm() / u_jax.norm()).item()
        assert rel < UPDATE_TOL[who], (who, rel)


def test_one_step_a_call_tracks_the_jax_trainer(tmp_path):
    j_calls, j_means, p_calls, p_means, weights, s0 = _run_both(
        tmp_path, steps_per_call=1, log_interval=1)
    assert [k for _, k in j_calls] == [1] * STEPS == p_calls
    assert [p for p, _ in j_calls] == ["gen"] * (D_START + 1) + ["gan"] * (
        STEPS - D_START - 1)
    assert "discriminator_loss" in p_means[-1]
    _check(j_means, p_means, weights, s0)


def test_four_steps_a_call_track_the_jax_trainer(tmp_path):
    j_calls, j_means, p_calls, p_means, weights, s0 = _run_both(
        tmp_path, steps_per_call=4, log_interval=8)
    assert j_calls == [("gen", 4), ("gen", 3), ("gan", 1), ("gan", 4),
                       ("gan", 4)]
    assert p_calls == [k for _, k in j_calls]
    _check(j_means, p_means, weights, s0)
