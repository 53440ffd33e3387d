"""The port's K-step B02 call (`B02TrainTask.multi_step`) on the CPU.

- Four gen steps then four gan steps in two calls equal eight eager
  `gen_step` / `gan_step` calls bit for bit (weights, batch-norm
  statistics, moments, counts, the draws' generator and the metrics),
  with every dropout on and the draws from the task's generator.
- The same calls against JAX `jax.jit(make_multi_step(task.{phase}_step))`
  on the draws JAX makes, rebuilt from its key splits
  (test_torch_b02_train.py's `jax_step_draws`) and passed as a list.
- `run_steps` waits on nothing and copies nothing from the host, as a
  captured CUDA graph needs: it runs with `.item()`, `.tolist()`,
  `__bool__`, `torch.tensor` and `pack_padded_sequence` patched to raise.

Sizes are test_torch_b02_train.py's (tiny widths, batch 2 x 24 frames,
10-frame discriminator windows).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svcc23_fastsvc_tpu.train.gan import make_multi_step
from svcc23_fastsvc_tpu_torch.compat import (
    subfreq_discriminator_state_dict_from_jax,
    tacotron2_state_dict_from_jax,
)
from svcc23_fastsvc_tpu_torch.data.wire import to_device
from test_torch_b02_train import (
    LENGTHS,
    _batch,
    _np,
    _rel,
    _rel_l2,
    _tasks,
    jax_step_draws,
)

K = 4


def _stacked(seed0):
    bs = [_batch(seed0 + i) for i in range(K)]
    return {k: np.stack([b[k] for b in bs]) for k in bs[0]}


def _state(task):
    out = [t.clone() for m in (task.generator, task.discriminator)
           for t in m.state_dict().values()]
    for opt in (task.g_opt, task.d_opt):
        out += [t.clone() for t in opt.mu + opt.nu]
    return out


def test_multi_step_equals_k_eager_steps():
    _, _, a = _tasks(dropout=True)
    _, _, b = _tasks(dropout=True)
    for phase, seed0 in (("gen", 40), ("gan", 50)):
        stacked = _stacked(seed0)
        ma = a.multi_step(phase, to_device(stacked, "cpu"))
        mb = [getattr(b, f"{phase}_step")(to_device(
            {k: v[i] for k, v in stacked.items()}, "cpu")) for i in range(K)]
        assert set(ma) == set(mb[0])
        for k, v in ma.items():
            assert v.shape == (K,)
            assert torch.equal(v, torch.stack([m[k] for m in mb])), k
    assert a.step == b.step == 2 * K
    assert (a.g_opt.count, a.d_opt.count) == (b.g_opt.count,
                                              b.d_opt.count) == (2 * K, K)
    for x, y in zip(_state(a), _state(b)):
        assert torch.equal(x, y)
    assert torch.equal(a.rng.get_state(), b.rng.get_state())


# f32 with every dropout on, eight steps across the phase switch and into
# RAdam's rectified update (step 5): the losses of every step within 1e-4
# relative and the whole update of G, and of D, within 1e-3 relative L2 of
# JAX's (test_torch_b02_train.py's trajectory rule: the rectified steps
# make per-tensor bounds meaningless).
def test_multi_step_matches_jax_make_multi_step():
    jtask, state, task = _tasks(dropout=True)
    g0 = {k: v.clone() for k, v in task.generator.state_dict().items()}
    d0 = {k: v.clone() for k, v in task.discriminator.state_dict().items()}
    for phase, seed0 in (("gen", 40), ("gan", 50)):
        stacked = _stacked(seed0)
        rng, draws = state.rng, []
        for _ in range(K):
            draws.append(jax_step_draws(jtask, phase, rng, LENGTHS))
            rng = jax.random.split(rng, 2 if phase == "gen" else 4)[0]
        state, jm = jax.jit(make_multi_step(getattr(jtask, f"{phase}_step")))(
            state, {k: jnp.asarray(v) for k, v in stacked.items()})
        np.testing.assert_array_equal(np.asarray(rng), np.asarray(state.rng))
        tm = task.multi_step(phase, to_device(stacked, "cpu"), draws)
        assert set(tm) == set(jm)
        for k in jm:
            for i in range(K):
                assert _rel(tm[k][i], jm[k][i]) < 1e-4, (phase, k, i)
    assert task.step == 2 * K == int(state.step)
    for port_sd, start, want in (
            (task.generator.state_dict(), g0,
             tacotron2_state_dict_from_jax(_np(state.g_params))),
            (task.discriminator.state_dict(), d0,
             subfreq_discriminator_state_dict_from_jax(_np(state.d_params)))):
        keys = [k for k, v in port_sd.items() if k in want
                and v.is_floating_point() and "running" not in k]
        assert _rel_l2({k: port_sd[k] - start[k] for k in keys},
                       {k: want[k] - start[k] for k in keys}) < 1e-3


def _raise(*args, **kwargs):
    raise AssertionError("host sync or host copy inside the step")


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_run_steps_needs_no_host_sync(monkeypatch, dtype):
    """What `train.graphs` captures, rehearsed on the CPU."""
    _, _, task = _tasks(dropout=True, compute_dtype=dtype)
    batches = {p: to_device(_stacked(s), "cpu") for p, s in (("gen", 60),
                                                              ("gan", 70))}
    tables = {p: torch.from_numpy(task.coefficient_table(2))
              for p in batches}
    task.g_opt._init_state()
    task.d_opt._init_state()
    for name in ("item", "tolist", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, _raise)
    monkeypatch.setattr(torch, "tensor", _raise)
    monkeypatch.setattr(torch.nn.utils.rnn, "pack_padded_sequence", _raise)
    for phase in ("gen", "gan"):
        two = {k: v[:2] for k, v in batches[phase].items()}
        metrics = task.run_steps(phase, two, tables[phase])
        assert all(v.shape == (2,) for v in metrics.values())
    monkeypatch.undo()
    assert task.step == 0 and task.g_opt.count == 0
