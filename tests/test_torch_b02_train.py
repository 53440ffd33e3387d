"""The port's B02 acoustic-model training slice against the JAX package's,
on the CPU.

The train-mode batch norm, the teacher-forced `Tacotron2.forward(train=
True)` with the masked MSE's gradient (f32 and bf16, dropout off; f32
with every dropout on, on the masks rebuilt from JAX's key splits), the
MultiSubFreqDiscriminator on given window starts and its weight bridge,
`B02TrainTask.gen_step` / `gan_step` (losses, updated G and D, running
statistics after the double update, no adversarial gradient on G), a
short trajectory across the phase boundary, `eval_step`, `B02Batcher`
and the packed wire are held against the JAX package on the same numpy
inputs (the CLI is in test_torch_b02_train_cli.py). Widths are tiny (the
`SMALL` dict of test_torch_tacotron2.py at the recipe's 60 mcep + 3 bap
outputs), batch 2 x 24 frames. Each tolerance is stated where it is used.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svcc23_fastsvc_tpu.compat import convert_subfreq_discriminator
from svcc23_fastsvc_tpu.data.collate import B02Batcher as JaxBatcher
from svcc23_fastsvc_tpu.data.wire import WirePacker as JaxPacker
from svcc23_fastsvc_tpu.models import tacotron2 as jt
from svcc23_fastsvc_tpu.train.b02 import B02TrainTask as JaxTask
from svcc23_fastsvc_tpu.train.state import make_optimizer
from svcc23_fastsvc_tpu_torch.compat import (
    subfreq_discriminator_state_dict_from_jax,
    tacotron2_state_dict_from_jax,
)
from svcc23_fastsvc_tpu_torch.config import build_b02_task
from svcc23_fastsvc_tpu_torch.data.collate import B02Batcher
from svcc23_fastsvc_tpu_torch.data.wire import WirePacker, to_device
from svcc23_fastsvc_tpu_torch.models import tacotron2 as tt
from svcc23_fastsvc_tpu_torch.train.b02 import B02TrainTask
from svcc23_fastsvc_tpu_torch.train.loop import Trainer
from svcc23_fastsvc_tpu_torch.train.state import RefRAdam

SMALL = dict(input_dim=16, output_dim=60, hidden_dim=32, dec_layers=2,
             spk_emb_dim=8, econv_chans=16, prenet_dim=8)
NO_DROPOUT = dict(enc_dropout_rate=0.0, dec_dropout_rate=0.0,
                  prenet_dropout_rate=0.0)
B, T, F = 2, 24, 10  # batch, frames, discriminator window
LENGTHS = [24, 17]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(seed, lengths=LENGTHS):
    r = np.random.default_rng(seed)
    return {
        "ppg": r.standard_normal((B, T, 16)).astype(np.float32),
        "lft": (0.3 * r.standard_normal((B, T, 1))).astype(np.float32),
        "lf0": (5 + 0.3 * r.standard_normal((B, T, 1))).astype(np.float32),
        "spk_emb": r.standard_normal((B, 8)).astype(np.float32),
        "targets": (0.5 * r.standard_normal((B, T, 63))).astype(np.float32),
        "lengths": np.asarray(lengths, np.int32),
    }


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _jax(dropout=False, bf16=False, window=F, lambda_adv=1.0):
    """The JAX task, its initial state and its jitted steps, made once per
    configuration (the tests share the compiles)."""
    jtask = JaxTask(
        generator=jt.Tacotron2(**SMALL, **({} if dropout else NO_DROPOUT)),
        discriminator=jt.MultiSubFreqDiscriminator(batch_max_frames=window),
        g_tx=make_optimizer(lr=1e-3, grad_norm=1.0),
        d_tx=make_optimizer(lr=1e-3, grad_norm=1.0),
        lambda_adv=lambda_adv,
        compute_dtype=jnp.bfloat16 if bf16 else None)
    return (jtask, jtask.init_state(jax.random.PRNGKey(6)),
            jax.jit(jtask.gen_step), jax.jit(jtask.gan_step))


def _tasks(*, dropout=False, compute_dtype=None, window=F, lambda_adv=1.0):
    """The JAX task and state, and the port task from the same weights."""
    jtask, state, _, _ = _jax(dropout, compute_dtype is not None, window,
                              lambda_adv)
    gen = tt.Tacotron2(**SMALL, **({} if dropout else NO_DROPOUT))
    gen.load_state_dict(tacotron2_state_dict_from_jax(_np(state.g_params)))
    dis = tt.MultiSubFreqDiscriminator(batch_max_frames=window)
    dis.load_state_dict(subfreq_discriminator_state_dict_from_jax(
        _np(state.d_params)))
    task = B02TrainTask(
        generator=gen, discriminator=dis,
        g_opt=RefRAdam(gen.parameters(), lr=1e-3, grad_norm=1.0),
        d_opt=RefRAdam(dis.parameters(), lr=1e-3, grad_norm=1.0),
        lambda_adv=lambda_adv, compute_dtype=compute_dtype,
        rng=torch.Generator().manual_seed(0))
    return jtask, state, task


def _jsteps(dropout=False, compute_dtype=None, window=F):
    return _jax(dropout, compute_dtype is not None, window)[2:]


# -- the random draws JAX makes, rebuilt from its key splits ---------------


def jax_model_draws(model, key, B, T, *, train=True):
    """The keep masks `Tacotron2.apply(..., targets, train=, key=key)`
    draws, in the port's `train_draws` layout: split(key, 3) -> k_enc,
    k_pre, k_dec; encoder: per conv key, sub = split(key), bernoulli(sub,
    1 - rate, (B, T, C)); prenet: per layer k_pre, sub = split(k_pre),
    (B, T, P); decoder: split(k_dec, T), per frame and cell kd, sub =
    split(kd), (B, H)."""
    k_enc, k_pre, k_dec = jax.random.split(key, 3)

    def mask(sub, rate, shape):
        if rate <= 0:
            return None
        return torch.from_numpy(np.asarray(
            jax.random.bernoulli(sub, 1.0 - rate, shape)))

    enc = []
    for _ in range(model.econv_layers):
        k_enc, sub = jax.random.split(k_enc)
        enc.append(mask(sub, model.enc_dropout_rate if train else 0.0,
                        (B, T, model.econv_chans)))
    pre = []
    for _ in range(model.prenet_layers):
        k_pre, sub = jax.random.split(k_pre)
        pre.append(mask(sub, model.prenet_dropout_rate,
                        (B, T, model.prenet_dim)))
    dec = None
    if train and model.dec_dropout_rate > 0:
        rows = []
        for kd in jax.random.split(k_dec, T):
            row = []
            for _ in range(model.dec_layers):
                kd, sub = jax.random.split(kd)
                row.append(mask(sub, model.dec_dropout_rate,
                                (B, model.hidden_dim)))
            rows.append(torch.stack(row))
        dec = torch.stack(rows)
    return {"enc": enc, "prenet": pre, "dec": dec}


def jax_starts(dis, key, lengths):
    """The window starts `MultiSubFreqDiscriminator.slice_windows` draws."""
    u = jax.random.uniform(key, (len(lengths),))
    max_start = jnp.maximum(jnp.asarray(lengths) - dis.batch_max_frames, 1)
    return torch.from_numpy(np.asarray((u * max_start).astype(jnp.int32)))


def jax_step_draws(jtask, phase, rng, lengths):
    """The draws of JAX's `gen_step` / `gan_step` from the state's rng."""
    g, d = jtask.generator, jtask.discriminator
    if phase == "gen":
        _, k = jax.random.split(rng)
        k_fwd, _ = jax.random.split(k)
        return {"g": jax_model_draws(g, k_fwd, B, T)}
    _, k1, k2, k3 = jax.random.split(rng, 4)
    k_fwd, k_d = jax.random.split(k1)
    kr, kf = jax.random.split(k3)
    return {"g": jax_model_draws(g, k_fwd, B, T),
            "d_g": jax_starts(d, k_d, lengths),
            "g2": jax_model_draws(g, k2, B, T),
            "d_real": jax_starts(d, kr, lengths),
            "d_fake": jax_starts(d, kf, lengths)}


# -- comparisons ------------------------------------------------------------


def _rel(got, want):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _flat(sd, keys):
    return torch.cat([torch.as_tensor(sd[k]).reshape(-1).double()
                      for k in keys])


def _rel_l2(got: dict, want: dict):
    keys = sorted(want)
    a, b = _flat(got, keys), _flat(want, keys)
    return ((a - b).norm() / b.norm()).item()


def _param_grads(module, loss):
    names = [n for n, _ in module.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in
                                       module.named_parameters()])
    return dict(zip(names, grads))


def _jax_bn_sd(g_bn):
    """JAX's running statistics under the port's buffer names."""
    sd = {}
    for i, s in enumerate(g_bn["encoder"]):
        sd[f"encoder.convs.{i}.1.running_mean"] = np.asarray(s["mean"])
        sd[f"encoder.convs.{i}.1.running_var"] = np.asarray(s["var"])
    sd["bap_decoder.10.running_mean"] = np.asarray(g_bn["bap"]["mean"])
    sd["bap_decoder.10.running_var"] = np.asarray(g_bn["bap"]["var"])
    return sd


def _port_bn_sd(bn):
    sd = {}
    for i, s in enumerate(bn["encoder"]):
        sd[f"encoder.convs.{i}.1.running_mean"] = s["mean"]
        sd[f"encoder.convs.{i}.1.running_var"] = s["var"]
    sd["bap_decoder.10.running_mean"] = bn["bap"]["mean"]
    sd["bap_decoder.10.running_var"] = bn["bap"]["var"]
    return sd


# -- the train-mode batch norm ----------------------------------------------


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_batch_norm_train_matches_jax(dtype):
    """y and the new running statistics: f32 within 1e-5 of max |y| and
    1e-6 of the statistics; bf16 y within 1e-2 (one bf16 rounding of y),
    the statistics (f32 in both) within 1e-5."""
    r = np.random.default_rng(2)
    x = jnp.asarray(r.standard_normal((3, 7, 5)) * 3 + 1, dtype)
    p = {"w": r.uniform(0.5, 1.5, 5), "b": r.normal(0, 0.1, 5),
         "mean": r.normal(0, 0.3, 5), "var": r.uniform(0.5, 2, 5)}
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), p)
    want, want_st = jt.batch_norm(x, jp, train=True)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(tdt)
    got, got_st = tt.batch_norm_train(
        xt, {k: torch.from_numpy(np.asarray(v)) for k, v in jp.items()})
    assert got.dtype == tdt and got_st["mean"].dtype == torch.float32
    assert _rel(got.float(), np.asarray(want, np.float32)) < (
        1e-5 if dtype == jnp.float32 else 1e-2)
    for k in ("mean", "var"):
        assert _rel(got_st[k], want_st[k]) < (
            1e-6 if dtype == jnp.float32 else 1e-5), k


# -- the teacher-forced forward and its gradient -----------------------------


# f32: the two packages differ by summation order only: loss within 1e-5
# relative, the running statistics within 1e-5, and the gradient of every
# tensor within 1e-4 of its max |g| (the 24-frame recurrence compounds the
# rounding), and within 1e-5 relative L2 over all of G. (Held this close,
# the comparison needs JAX's leaky-ReLU derivative at 0, which the port's
# `ops.conv.leaky_relu` takes: the zero-bias convs give exact zeros at the
# padded frames.)
# bf16: both round the stream after every op, in different places inside
# the matmuls and the recurrence, so bf16 is held as a whole: the loss to
# 2e-2 relative, the statistics (f32 from bf16 activations) to 2e-2, and
# the gradient of all of G to 0.15 relative L2 (the JAX package's own bf16
# gradient lies about 0.05 from its f32 one on this model).
GRAD_TOL = {None: 1e-5, torch.bfloat16: 0.15}


@pytest.mark.parametrize("dropout,dtype", [
    (False, None), (False, torch.bfloat16), (True, None)],
    ids=["f32", "bf16", "f32-dropout"])
def test_teacher_forced_loss_and_gradient_match_jax(dropout, dtype):
    jtask, state, task = _tasks(dropout=dropout, compute_dtype=dtype)
    batch = _batch(7)
    key = jax.random.PRNGKey(11)
    (jloss, (jm, jbn)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtask._gen_loss(p, state.d_params, _jbatch(batch), key,
                                  with_adv=False, g_bn=state.g_bn),
        has_aux=True))(state.g_params)
    k_fwd, _ = jax.random.split(key)
    draws = {"g": jax_model_draws(jtask.generator, k_fwd, B, T)}
    if dropout:  # every dropout drew a mask
        assert all(m is not None for m in draws["g"]["enc"])
        assert draws["g"]["dec"].shape == (T, 2, B, 32)
    loss, metrics, bn = task._gen_loss(to_device(batch, "cpu"), draws,
                                       with_adv=False)
    grads = _param_grads(task.generator, loss)
    want = {k: v for k, v in tacotron2_state_dict_from_jax(_np(jgrads))
            .items() if k in grads}
    assert set(want) == set(grads)
    tol = 1e-5 if dtype is None else 2e-2
    assert _rel(metrics["mse_loss"], jm["mse_loss"]) < tol
    assert _rel(loss, jloss) < tol
    jst = _jax_bn_sd(jbn)
    for k, v in _port_bn_sd(bn).items():
        assert v.dtype == torch.float32
        assert _rel(v, jst[k]) < tol, k
    assert _rel_l2(grads, want) < GRAD_TOL[dtype]
    if dtype is None:
        # conv3's bias feeds the bap batch norm: its exact gradient is 0,
        # so each tensor's scale is at least 1e-3 of the largest gradient
        top = max(v.abs().max().item() for v in want.values())
        for k, g in grads.items():
            err = (g - want[k]).abs().max().item()
            assert err <= 1e-4 * max(want[k].abs().max().item(),
                                     1e-3 * top), k


def test_teacher_forced_forward_output_matches_jax():
    """The prediction itself (B, T, 63) and the returned lengths: train
    mode with every dropout on, within 1e-5 of max |y|; eval mode (the
    running statistics, the prenet's dropout only) too."""
    jtask, state, task = _tasks(dropout=True)
    batch = _batch(8)
    key = jax.random.PRNGKey(12)
    for train in (True, False):
        want = jax.jit(lambda p, *a, train=train: jtask.generator.apply(
            p, *a, train=train, key=key)[0])(
            state.g_params, *(jnp.asarray(batch[k]) for k in (
                "ppg", "lengths", "lft", "lf0", "spk_emb", "targets")))
        draws = jax_model_draws(jtask.generator, key, B, T, train=train)
        t = to_device(batch, "cpu")
        with torch.no_grad():
            got, lengths, _ = task.generator(
                t["ppg"], t["lengths"], t["lft"], t["lf0"], t["spk_emb"],
                t["targets"], train=train, draws=draws)
        assert got.shape == (B, T, 63) and lengths is t["lengths"]
        assert _rel(got, want) < 1e-5, train


# -- the discriminator --------------------------------------------------------


def test_subfreq_discriminator_matches_jax_on_given_starts():
    """Windows of 10 frames from starts JAX draws (lengths past the window,
    so the starts differ from 0): the three band logit maps, low, mid,
    high, within 1e-5 of max |y| (f32); the bridge round-trips through the
    JAX package's convert_subfreq_discriminator bit for bit."""
    jd = jt.MultiSubFreqDiscriminator(batch_max_frames=F)
    params = jd.init(jax.random.PRNGKey(3))
    port = tt.MultiSubFreqDiscriminator(batch_max_frames=F)
    port.load_state_dict(subfreq_discriminator_state_dict_from_jax(
        _np(params)))
    x = np.random.default_rng(4).standard_normal((B, T, 63)).astype(
        np.float32)
    key = jax.random.PRNGKey(5)
    want = jd.apply(params, jnp.asarray(x), jnp.asarray(LENGTHS), key)
    starts = jax_starts(jd, key, LENGTHS)
    assert starts.max() > 0
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.tensor(LENGTHS),
                   starts=starts)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == (B, F, 30)
        assert _rel(g, w) < 1e-5
    back = convert_subfreq_discriminator(
        {k: v.numpy() for k, v in port.state_dict().items()})
    flat_a, tree_a = jax.tree.flatten(params)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the port's own starts follow JAX's rule: all 0 within the window
    gen = torch.Generator().manual_seed(0)
    assert port.window_starts(torch.tensor([F + 1, 3]),
                              generator=gen).tolist() == [0, 0]


# -- the train steps -------------------------------------------------------


# f32: as in the forward test, plus two RAdam updates of lr 1e-3: every
# parameter within 2e-3 of how far JAX moved it plus 4e-7 of its size (the
# rule of test_torch_train.py) plus 1e-9 (conv3's bias, whose exact
# gradient is 0, moves by rounding noise of 1e-13), losses within 1e-5
# relative, the running statistics within 1e-5 relative. bf16: the
# updates of all of G, and of all of D, within 0.3 relative L2 of JAX's
# (test_torch_train.py's rule), the losses and statistics within 2e-2
# relative.
@pytest.mark.parametrize("dropout,dtype", [
    (False, None), (False, torch.bfloat16), (True, None)],
    ids=["f32", "bf16", "f32-dropout"])
def test_gen_then_gan_step_match_jax(dropout, dtype):
    # dropout off: windows as long as the batch, so every start is 0 in
    # both packages; dropout on: JAX's masks and starts, rebuilt
    window = F if dropout else T
    jtask, state, task = _tasks(dropout=dropout, compute_dtype=dtype,
                                window=window)
    g0 = {k: v.clone() for k, v in task.generator.state_dict().items()}
    d0 = {k: v.clone() for k, v in task.discriminator.state_dict().items()}
    tol = 1e-5 if dtype is None else 2e-2
    for i, phase in enumerate(("gen", "gan")):
        batch = _batch(20 + i)
        draws = (jax_step_draws(jtask, phase, state.rng, LENGTHS)
                 if dropout else None)
        state, jm = _jsteps(dropout, dtype, window)[i](state,
                                                       _jbatch(batch))
        tm = getattr(task, f"{phase}_step")(to_device(batch, "cpu"), draws)
        assert set(tm) == set(jm)
        for k in jm:
            assert _rel(tm[k], jm[k]) < tol, (phase, k)
    assert task.step == 2 and int(state.step) == 2
    jst = _jax_bn_sd(state.g_bn)
    port_g = task.generator.state_dict()
    for k, v in jst.items():
        assert _rel(port_g[k], v) < tol, k
    for port_sd, start, want in (
            (port_g, g0, tacotron2_state_dict_from_jax(_np(state.g_params))),
            (task.discriminator.state_dict(), d0,
             subfreq_discriminator_state_dict_from_jax(_np(state.d_params)))):
        keys = [k for k, v in port_sd.items() if k in want and
                v.is_floating_point() and "running" not in k]
        for k in keys:
            assert torch.isfinite(port_sd[k]).all(), k
            if dtype is None:
                moved = (want[k] - start[k]).abs().max().item()
                err = (port_sd[k] - want[k]).abs().max().item()
                assert err <= 2e-3 * moved + 4e-7 * want[k].abs().max(
                    ).item() + 1e-9, k
        if dtype is not None:
            u_port = {k: port_sd[k] - start[k] for k in keys}
            u_jax = {k: want[k] - start[k] for k in keys}
            assert _rel_l2(u_port, u_jax) < 0.3


def test_gan_step_gives_g_no_adversarial_gradient():
    """The detached discriminator input: lambda_adv 1 and 100 give the same
    G bit for bit after a gan_step, and different generator losses."""
    out = []
    for lam in (1.0, 100.0):
        _, _, task = _tasks(dropout=True, lambda_adv=lam)
        m = task.gan_step(to_device(_batch(9), "cpu"))
        out.append((m, task.generator.state_dict()))
    (m1, g1), (m2, g2) = out
    assert all(torch.equal(v, g2[k]) for k, v in g1.items())
    assert m1["mse_loss"] == m2["mse_loss"]
    assert m2["generator_loss"] - m2["mse_loss"] == pytest.approx(
        100 * (m1["generator_loss"] - m1["mse_loss"]).item(), rel=1e-5)


def test_gan_step_updates_running_statistics_twice():
    """After a gan_step the running statistics are those of two chained
    momentum updates: the G step's forward, then the updated G's forward
    on the same batch (equal to JAX's in the step test above); one
    gen_step from the same state gives the first update only."""
    batch = to_device(_batch(10), "cpu")
    _, _, a = _tasks()
    _, _, b = _tasks()
    a.gen_step(batch)
    b.gan_step(batch)
    one = a.generator.bap_decoder[10].running_mean
    two = b.generator.bap_decoder[10].running_mean
    # the updated G barely moves in one step, so the batch statistics of
    # the two forwards nearly agree: two updates give ~1.9x one update
    ratio = (two.abs().sum() / one.abs().sum()).item()
    assert 1.8 < ratio < 2.0, ratio
    for k in ("running_mean", "running_var"):
        st = [bn.state_dict()[k] for bn in (
            a.generator.encoder.convs[0][1], b.generator.encoder.convs[0][1])]
        assert not torch.equal(*st)


def test_trajectory_across_the_phase_boundary_matches_jax():
    """3 gen_steps then 3 gan_steps, f32, a new batch each step: the whole
    update of G, and of D, within 1e-3 relative L2 of JAX's, and the last
    losses within 1e-4. RAdam's zero-gradient drift (ROADMAP.md, "RAdam and
    parity") makes per-tensor bounds meaningless over a trajectory."""
    jtask, state, task = _tasks(window=T)
    g0 = {k: v.clone() for k, v in task.generator.state_dict().items()}
    d0 = {k: v.clone() for k, v in task.discriminator.state_dict().items()}
    jgen, jgan = _jsteps(window=T)
    for i in range(6):
        batch = _batch(30 + i)
        state, jm = (jgen if i < 3 else jgan)(state, _jbatch(batch))
        tm = (task.gen_step if i < 3 else task.gan_step)(
            to_device(batch, "cpu"))
    for k in jm:
        assert _rel(tm[k], jm[k]) < 1e-4, k
    for port_sd, start, want in (
            (task.generator.state_dict(), g0,
             tacotron2_state_dict_from_jax(_np(state.g_params))),
            (task.discriminator.state_dict(), d0,
             subfreq_discriminator_state_dict_from_jax(_np(state.d_params)))):
        keys = [k for k, v in port_sd.items() if k in want
                and v.is_floating_point() and "running" not in k]
        assert _rel_l2({k: port_sd[k] - start[k] for k in keys},
                       {k: want[k] - start[k] for k in keys}) < 1e-3
    assert task.g_opt.count == 6 and task.d_opt.count == 3


def test_eval_step_matches_jax_and_leaves_the_stream():
    """eval_step after a gen_step: the running statistics, no dropout but
    the prenet's (off here), no adversarial term: the MSE within 1e-5 of
    JAX's; the task's generator state is unchanged by it."""
    jtask, state, task = _tasks(window=T)
    batch = _batch(11)
    state, _ = _jsteps(window=T)[0](state, _jbatch(batch))
    task.gen_step(to_device(batch, "cpu"))
    want = jax.jit(jtask.eval_step)(state, _jbatch(_batch(12)))
    rng = task.rng.get_state()
    got = task.eval_step(to_device(_batch(12), "cpu"))
    assert set(got) == set(want) == {"mse_loss", "generator_loss"}
    assert _rel(got["mse_loss"], want["mse_loss"]) < 1e-5
    assert torch.equal(task.rng.get_state(), rng)


# -- build_b02_task, the trainer, data and wire ----------------------------


def test_build_b02_task_defaults():
    """B02's own optimizer defaults (grad norm 1 for both, no weight decay)
    and lambdas of 1, not the FastSVC ones; K steps a call are taken (on
    the CPU by the task's eager `multi_step`, no graphs)."""
    cfg = {"generator_params": SMALL, "compute_dtype": "bfloat16",
           "discriminator_params": {"batch_max_frames": 7}}
    task = build_b02_task(cfg, device="cpu", seed=1)
    assert task.g_opt.grad_norm == task.d_opt.grad_norm == 1
    assert task.g_opt.weight_decay == task.d_opt.weight_decay == 0.0
    assert task.lambda_l1 == task.lambda_adv == 1.0
    assert task.compute_dtype == torch.bfloat16
    assert task.discriminator.batch_max_frames == 7
    assert set(task.generator.state_dict()) == set(
        tacotron2_state_dict_from_jax(_np(jt.Tacotron2(**SMALL).init(
            jax.random.PRNGKey(0)))))
    trainer = Trainer(task, None, config={"steps_per_call": 4},
                      outdir="unused")
    assert trainer.steps_per_call == 4 and trainer._graphs is None
    assert callable(task.multi_step)


def _items(n=4, seed=13):
    """Utterances in the port's B02Dataset layout."""
    r = np.random.default_rng(seed)
    items = []
    for j in range(n):
        nf = 15 + 6 * j
        items.append((f"spk_{j}", r.standard_normal(nf * 40),
                      r.uniform(80, 300, nf),
                      r.standard_normal((nf, 16)).astype(np.float32),
                      r.standard_normal((nf, 1)).astype(np.float32),
                      r.standard_normal((nf, 1)).astype(np.float32),
                      np.ones((nf, 1), np.float32),
                      r.standard_normal((nf, 60)).astype(np.float32),
                      r.standard_normal((nf, 3)).astype(np.float32),
                      r.standard_normal((1, 8)).astype(np.float32)))
    return items


def test_b02_batcher_matches_jax():
    """Same seed, same utterances: the same batches as the JAX batcher,
    batch for batch (lengths cut to max_frames)."""
    items = _items()
    port = B02Batcher(items, batch_size=3, max_frames=24, seed=5)
    ref = JaxBatcher([it[1:] for it in items], batch_size=3, max_frames=24,
                     seed=5)
    for _ in range(4):
        got, want = port.sample_batch(), ref.sample_batch()
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], k)
    assert got["lengths"].max() <= 24


def test_packed_wire_equals_f32_wire_under_bf16():
    """The packed wire turns ppg into bf16 and touches nothing else, as the
    JAX packer does; a bf16 gan_step on it gives the f32 wire's metrics
    and weights bit for bit (the step casts ppg to bf16 anyway)."""
    batch = _batch(14)
    packed = WirePacker(hop_size=160)(batch)
    jpacked = JaxPacker(hop_size=160)(batch)
    assert packed["ppg"].dtype == torch.bfloat16
    for k, v in batch.items():
        if k != "ppg":
            assert packed[k] is v, k
        np.testing.assert_array_equal(
            np.asarray(torch.as_tensor(packed[k]).float()),
            np.asarray(jpacked[k], np.float32), k)
    runs = []
    for b in (batch, packed):
        _, _, task = _tasks(dropout=True, compute_dtype=torch.bfloat16)
        runs.append((task.gan_step(to_device(b, "cpu")),
                     task.generator.state_dict(),
                     task.discriminator.state_dict()))
    (m1, g1, d1), (m2, g2, d2) = runs
    assert all(torch.equal(v, m2[k]) for k, v in m1.items())
    for a, c in ((g1, g2), (d1, d2)):
        assert all(torch.equal(v, c[k]) for k, v in a.items())


def test_trainer_runs_b02_on_the_cpu(tmp_path):
    """Trainer.run with a B02 task: 2 gen and 2 gan steps, frames/s in the
    log, an eval (no with_adv argument) and a checkpoint that a fresh task
    reloads to the same state."""
    from svcc23_fastsvc_tpu_torch.train.checkpoint import load_checkpoint

    cfg = {"generator_params": SMALL,
           "discriminator_params": {"batch_max_frames": 8},
           "batch_size": 2, "discriminator_train_start_steps": 1,
           "train_max_steps": 4, "log_interval_steps": 2,
           "eval_interval_steps": 2, "save_interval_steps": 4,
           "eval_batches": 1}
    task = build_b02_task(cfg, device="cpu", seed=2)
    items = _items()
    trainer = Trainer(task, B02Batcher(items, batch_size=2, max_frames=20),
                      config=cfg, outdir=str(tmp_path),
                      dev_batcher=B02Batcher(items, batch_size=2,
                                             max_frames=20, seed=1))
    trainer.run()
    assert task.step == 4 and len(trainer.history) == 2
    assert "frames_per_s" in trainer.history[0]
    assert "discriminator_loss" in trainer.history[1]
    fresh = build_b02_task(cfg, device="cpu", seed=9)
    load_checkpoint(str(tmp_path / "checkpoint-4steps.pkl"), fresh)
    for a, b in ((task.generator, fresh.generator),
                 (task.discriminator, fresh.discriminator)):
        for (k, v), w in zip(a.state_dict().items(),
                             b.state_dict().values()):
            assert torch.equal(v, w), k
    assert torch.equal(fresh.rng.get_state(), task.rng.get_state())
    assert fresh.g_opt.count == 4 and fresh.d_opt.count == 2


def test_train_draws_have_jax_layout():
    """The port's own draws have the layout and rates of the masks JAX
    draws: train mode every dropout, eval mode the prenet's only."""
    model = jt.Tacotron2(**SMALL)
    want = jax_model_draws(model, jax.random.PRNGKey(0), B, T)
    port = tt.Tacotron2(**SMALL)
    gen = torch.Generator().manual_seed(3)
    got = port.train_draws(B, T, generator=gen)
    for k in ("enc", "prenet"):
        assert [m.shape for m in got[k]] == [m.shape for m in want[k]]
    assert got["dec"].shape == want["dec"].shape == (T, 2, B, 32)
    assert got["dec"].dtype == torch.bool
    assert 0.7 < got["dec"].float().mean().item() < 0.9  # keep 1 - 0.2
    ev = port.train_draws(B, T, train=False, generator=gen)
    assert ev["dec"] is None and ev["enc"] == [None] * 3
    assert [m.shape for m in ev["prenet"]] == [(B, T, 8)] * 2
