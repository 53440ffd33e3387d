"""The port's FastSVC training slice against the JAX package's, on the CPU.

Losses, the MelGAN multi-scale discriminator, the optimizer chain, a
gen_step then a gan_step from converted weights, the wire format and the
batcher are held against their JAX counterparts on the same numpy inputs
(the CLI is in test_torch_train_cli.py). Sizes are tiny (two narrow
blocks, 200-sample crops). Each tolerance is stated where it is used.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from svcc23_fastsvc_tpu.compat import convert_melgan_msd
from svcc23_fastsvc_tpu.data.collate import FastSVCBatcher as JaxBatcher
from svcc23_fastsvc_tpu.data.wire import WirePacker as JaxPacker
from svcc23_fastsvc_tpu.losses import (
    MultiResolutionSTFTLoss as JaxSTFTLoss,
    discriminator_adversarial_loss as jax_d_loss,
    generator_adversarial_loss as jax_g_loss,
    masked_mse_loss as jax_masked_mse,
)
from svcc23_fastsvc_tpu.models.fastsvc import FastSVCGenerator as JaxGen
from svcc23_fastsvc_tpu.models.fastsvc import (
    MelGANMultiScaleDiscriminator as JaxMSD,
)
from svcc23_fastsvc_tpu.ops.signal_gen import SignalGenerator as JaxSigGen
from svcc23_fastsvc_tpu.train import FastSVCTrainTask as JaxTask
from svcc23_fastsvc_tpu.train import make_optimizer as jax_make_optimizer
from svcc23_fastsvc_tpu_torch.compat import (
    generator_state_dict_from_jax,
    melgan_msd_state_dict_from_jax,
)
from svcc23_fastsvc_tpu_torch.data.collate import FastSVCBatcher
from svcc23_fastsvc_tpu_torch.data.wire import (
    WirePacker,
    to_device,
    unpack_batch,
)
from svcc23_fastsvc_tpu_torch.losses import (
    MultiResolutionSTFTLoss,
    discriminator_adversarial_loss,
    generator_adversarial_loss,
    masked_mse_loss,
)
from svcc23_fastsvc_tpu_torch.models.fastsvc import (
    FastSVCGenerator,
    MelGANMultiScaleDiscriminator,
)
from svcc23_fastsvc_tpu_torch.ops.signal_gen import SignalGenerator
from svcc23_fastsvc_tpu_torch.train.gan import FastSVCTrainTask
from svcc23_fastsvc_tpu_torch.train.state import (
    RefRAdam,
    radam_coefficients,
)

GEN = dict(in_channels=8, mid_channels=(16, 8), upsampling_scales=(4, 5),
           spk_emb_size=12)
DIS = dict(scales=2, channels=4, max_downsample_channels=32,
           downsample_scales=(4, 4))
STFT = ((64, 128), (16, 32), (64, 128))
SR, HOP = 4000, 20


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _rel_err(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


# -- losses --------------------------------------------------------------


def test_stft_loss_matches_jax():
    """f32, 1e-5 of each loss: cuFFT/pocketfft and XLA's FFT differ by
    float rounding only."""
    r = np.random.default_rng(0)
    x = r.standard_normal((3, 1000)).astype(np.float32)
    y = r.standard_normal((3, 1000)).astype(np.float32)
    res = ((128, 64, 256), (32, 16, 128), (128, 64, 64))  # win < fft too
    got = MultiResolutionSTFTLoss(*res)(torch.from_numpy(x),
                                        torch.from_numpy(y))
    want = JaxSTFTLoss(*res)(jnp.asarray(x), jnp.asarray(y))
    for a, b in zip(got, want):
        assert _rel_err(a, b) < 1e-5
    # (B, T, C) input takes the same path
    got3 = MultiResolutionSTFTLoss(*res)(torch.from_numpy(x)[..., None],
                                         torch.from_numpy(y)[..., None])
    for a, b in zip(got3, got):
        assert float(a) == float(b)


@pytest.mark.parametrize("loss_type", ["mse", "hinge"])
def test_adversarial_losses_match_jax(loss_type):
    """Nested (MelGAN) outputs: only each scale's last layer is scored;
    1e-6 relative in f32."""
    r = np.random.default_rng(1)
    outs = [[r.standard_normal((2, n, 1)).astype(np.float32)
             for n in (40, 10)] for _ in range(3)]
    outs_hat = [[r.standard_normal((2, n, 1)).astype(np.float32)
                 for n in (40, 10)] for _ in range(3)]
    t = lambda o: [[torch.from_numpy(a) for a in s] for s in o]  # noqa: E731
    j = lambda o: [[jnp.asarray(a) for a in s] for s in o]  # noqa: E731
    assert _rel_err(generator_adversarial_loss(t(outs_hat),
                                               loss_type=loss_type),
                    jax_g_loss(j(outs_hat), loss_type=loss_type)) < 1e-6
    for a, b in zip(discriminator_adversarial_loss(t(outs_hat), t(outs),
                                                   loss_type=loss_type),
                    jax_d_loss(j(outs_hat), j(outs), loss_type=loss_type)):
        assert _rel_err(a, b) < 1e-6


def test_masked_mse_matches_jax():
    r = np.random.default_rng(2)
    x = r.standard_normal((3, 12, 4)).astype(np.float32)
    y = r.standard_normal((3, 10, 4)).astype(np.float32)
    lengths = np.array([12, 5, 8])
    got = masked_mse_loss(torch.from_numpy(x), torch.from_numpy(y),
                          torch.from_numpy(lengths))
    want = jax_masked_mse(jnp.asarray(x), jnp.asarray(y), jnp.asarray(lengths))
    assert _rel_err(got, want) < 1e-6


# -- the discriminator ----------------------------------------------------


def test_msd_forward_matches_jax_and_converts_back():
    """JAX params -> melgan_msd_state_dict_from_jax -> the port: every
    layer's output within 1e-5 of its max |y| (f32), and the port's
    state_dict converts back to the same params bit for bit."""
    jd = JaxMSD(**DIS)
    params = jd.init(jax.random.PRNGKey(3))
    port = MelGANMultiScaleDiscriminator(**DIS)
    port.load_state_dict(melgan_msd_state_dict_from_jax(
        jax.tree.map(np.asarray, params)))
    x = np.random.default_rng(4).standard_normal((2, 400, 1)).astype(
        np.float32)
    want = jd.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == len(want) == DIS["scales"]
    for gs, ws in zip(got, want):
        assert len(gs) == len(ws) == 5
        for g_, w_ in zip(gs, ws):
            assert _rel_err(g_, w_) < 1e-5
    back = convert_melgan_msd(port.state_dict(), scales=DIS["scales"])
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- the optimizer --------------------------------------------------------


def test_radam_coefficients_reach_the_rectified_branch():
    """t <= 4 takes the SGD fallback (rho_t < 5), t >= 5 the rectified
    step; rect matches the reference's f64 formula to f32 rounding."""
    b1, b2 = 0.9, 0.999
    rho_inf = 2 / (1 - b2) - 1
    for t in range(1, 40):
        use_rect, rect, sgd = radam_coefficients(t)
        b2t = b2 ** t
        rho = rho_inf - 2 * t * b2t / (1 - b2t)
        assert use_rect == (rho >= 5), t
        assert sgd == pytest.approx(1 / (1 - b1 ** t), rel=1e-6)
        if use_rect:
            want = np.sqrt((1 - b2t) * (rho - 4) / (rho_inf - 4)
                           * (rho - 2) / rho * rho_inf / (rho_inf - 2)) \
                / (1 - b1 ** t)
            assert rect == pytest.approx(want, rel=2e-6), t


@pytest.mark.parametrize("clip,wd", [(0.0, 0.0), (2.0, 0.0), (10.0, 1e-2)])
def test_optimizer_matches_jax_make_optimizer(clip, wd):
    """Clip -> ref RAdam -> weight decay -> StepLR over 12 steps (the SGD
    fallback, then rho_t >= 5 from step 5; the lr halves at step 10), grads
    over 5 decades: parameters within 2e-6 absolute, the bound the JAX
    package holds its own chain to against the reference torch RAdam."""
    r = np.random.default_rng(5)
    p0 = [r.standard_normal(s).astype(np.float32) for s in ((64,), (3, 5))]
    grads = [[(r.standard_normal(p.shape) * 10 ** r.uniform(-4, 1)).astype(
        np.float32) for p in p0] for _ in range(12)]
    kw = dict(lr=1e-2, eps=1e-6, weight_decay=wd, grad_norm=clip,
              scheduler_step_size=10, scheduler_gamma=0.5)
    tx = jax_make_optimizer(**kw)
    pj = [jnp.asarray(p) for p in p0]
    st = tx.init(pj)
    pt = [torch.from_numpy(p.copy()) for p in p0]
    opt = RefRAdam(pt, **kw)
    for g in grads:
        u, st = tx.update([jnp.asarray(a) for a in g], st, pj)
        pj = optax.apply_updates(pj, u)
        opt.step([torch.from_numpy(a) for a in g])
    assert opt.count == 12
    for a, b in zip(pt, pj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=2e-6)


# -- the train step -------------------------------------------------------


def _tasks(compute_dtype):
    """The JAX task and state, and the port task from the same weights."""
    jtask = JaxTask(
        generator=JaxGen(**GEN), discriminator=JaxMSD(**DIS),
        g_tx=jax_make_optimizer(lr=1e-3, grad_norm=10.0),
        d_tx=jax_make_optimizer(lr=1e-3, grad_norm=1.0),
        signal_generator=JaxSigGen(sample_rate=SR, hop_size=HOP),
        stft_loss=JaxSTFTLoss(*STFT),
        compute_dtype=None if compute_dtype is None else jnp.bfloat16)
    state = jtask.init_state(jax.random.PRNGKey(6))
    gen = FastSVCGenerator(**GEN)
    gen.load_state_dict(generator_state_dict_from_jax(
        jax.tree.map(np.asarray, state.g_params)))
    dis = MelGANMultiScaleDiscriminator(**DIS)
    dis.load_state_dict(melgan_msd_state_dict_from_jax(
        jax.tree.map(np.asarray, state.d_params)))
    task = FastSVCTrainTask(
        generator=gen, discriminator=dis,
        g_opt=RefRAdam(gen.parameters(), lr=1e-3, grad_norm=10.0),
        d_opt=RefRAdam(dis.parameters(), lr=1e-3, grad_norm=1.0),
        signal_generator=SignalGenerator(sample_rate=SR, hop_size=HOP),
        stft_loss=MultiResolutionSTFTLoss(*STFT),
        compute_dtype=compute_dtype, rng=torch.Generator().manual_seed(0))
    return jtask, state, task


def _batch(seed, B=2, Tf=10):
    r = np.random.default_rng(seed)
    t = np.arange(Tf * HOP) / SR
    audio = 0.1 * np.sin(2 * np.pi * 220 * t) + 0.01 * r.standard_normal(
        (B, Tf * HOP))
    return {
        "ppg": r.standard_normal((B, Tf, 8)).astype(np.float32),
        "f0": np.full((B, Tf, 1), 220.0, np.float32),
        "lft": (0.1 * r.standard_normal((B, Tf * HOP, 1))).astype(np.float32),
        "spk_emb": r.standard_normal((B, 12)).astype(np.float32),
        "audio": audio[..., None].astype(np.float32),
        # an explicit excitation: the two frameworks' noise streams differ
        "sine": (0.1 * r.standard_normal((B, Tf * HOP, 1))).astype(
            np.float32),
    }


# f32: the frameworks differ by summation order only. Losses agree to
# 1e-4 relative and each parameter to |p_port - p_jax| <= 2e-3 *
# max |p_jax - p_start| + 4e-7 * max |p| (the second term is 3 f32
# roundings of the parameter itself, which two steps of lr 1e-3 move by as
# little as 1e-6).
# bf16: the two round in different places through ~20 layers (conv sums,
# weight norm, FiLM). On this config the JAX package's own bf16 gradient is
# 14% (relative L2 over all of G) from its f32 gradient, and the port's
# bf16 gradient 14% from JAX's, so bf16 is held as a whole: losses to 3e-2
# relative, and the update of all of G, and of all of D, to 0.3 relative L2
# of JAX's update (about twice bf16's own distance from f32).
LOSS_TOL = {None: 1e-4, torch.bfloat16: 3e-2}


def _flat(sd, keys):
    return torch.cat([sd[k].reshape(-1).float() for k in keys])


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_gen_then_gan_step_match_jax(dtype):
    jtask, state, task = _tasks(dtype)
    g0 = {k: v.clone() for k, v in task.generator.state_dict().items()}
    d0 = {k: v.clone() for k, v in task.discriminator.state_dict().items()}
    for i, phase in enumerate(("gen", "gan")):
        batch = _batch(7 + i)
        state, jm = jax.jit(getattr(jtask, f"{phase}_step"))(
            state, {k: jnp.asarray(v) for k, v in batch.items()})
        tm = getattr(task, f"{phase}_step")(to_device(batch, "cpu"))
        assert set(tm) == set(jm)
        for k in jm:
            assert _rel_err(tm[k], jm[k]) < LOSS_TOL[dtype], (phase, k)
    assert task.step == 2 and int(state.step) == 2
    jg = jax.tree.map(np.asarray, state.g_params)
    jd = jax.tree.map(np.asarray, state.d_params)
    for port_sd, start, jparams in (
            (task.generator.state_dict(), g0,
             generator_state_dict_from_jax(jg)),
            (task.discriminator.state_dict(), d0,
             melgan_msd_state_dict_from_jax(jd))):
        assert set(port_sd) == set(jparams)
        for k, v in port_sd.items():
            assert torch.isfinite(v).all(), k
            if dtype is None:
                moved = (jparams[k] - start[k]).abs().max().item()
                err = (v - jparams[k]).abs().max().item()
                assert err <= 2e-3 * moved + 4e-7 * v.abs().max().item(), k
        if dtype is not None:
            keys = sorted(port_sd)
            u_port = _flat(port_sd, keys) - _flat(start, keys)
            u_jax = _flat(jparams, keys) - _flat(start, keys)
            assert ((u_port - u_jax).norm() / u_jax.norm()).item() < 0.3


# -- data -----------------------------------------------------------------


def _pcm_batch(seed, B=3, Tf=12):
    r = np.random.default_rng(seed)
    audio = r.integers(-32768, 32767, (B, Tf * HOP, 1)) / 32768.0
    lft = np.repeat(r.standard_normal((B, Tf, 1)), HOP, axis=1)
    return {"audio": audio.astype(np.float32),
            "lft": lft.astype(np.float32),
            "ppg": r.standard_normal((B, Tf, 8)).astype(np.float32),
            "f0": r.uniform(80, 300, (B, Tf, 1)).astype(np.float32),
            "spk_emb": r.standard_normal((B, 12)).astype(np.float32)}


@pytest.mark.parametrize("hop_constant", [True, False])
def test_wire_packer_round_trip_and_matches_jax(hop_constant):
    """int16 PCM audio and hop-constant lft come back bit for bit, ppg as
    its bf16 rounding; the packed fields equal the JAX packer's."""
    batch = _pcm_batch(8)
    if not hop_constant:
        batch["lft"] = batch["lft"] + np.float32(1e-3) * np.arange(
            batch["lft"].shape[1], dtype=np.float32)[None, :, None]
    packed = WirePacker(hop_size=HOP)(batch)
    jpacked = JaxPacker(hop_size=HOP)(batch)
    for k in batch:
        np.testing.assert_array_equal(_np(packed[k]),
                                      np.asarray(jpacked[k], np.float32))
    assert packed["audio"].dtype == np.int16
    assert (packed["lft"].shape[1] == 12) == hop_constant
    out = unpack_batch(to_device(packed, "cpu"), hop_size=HOP)
    np.testing.assert_array_equal(out["audio"].numpy(), batch["audio"])
    want_lft = batch["lft"] if hop_constant else _np(
        torch.from_numpy(batch["lft"]).to(torch.bfloat16))
    np.testing.assert_array_equal(_np(out["lft"]), want_lft)
    assert out["ppg"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(out["ppg"]), _np(
        torch.from_numpy(batch["ppg"]).to(torch.bfloat16)))
    # an f32 batch passes unchanged
    again = unpack_batch(to_device(batch, "cpu"), hop_size=HOP)
    for k in batch:
        np.testing.assert_array_equal(again[k].numpy(), batch[k])


def _utterances(n=4, seed=9):
    r = np.random.default_rng(seed)
    items = []
    for j in range(n):
        nf = 30 + 7 * j
        items.append((f"spk_utt{j}",
                      r.standard_normal(nf * HOP).astype(np.float32),
                      r.uniform(80, 300, nf).astype(np.float32),
                      r.standard_normal((nf, 8)).astype(np.float32),
                      r.standard_normal(nf * HOP).astype(np.float32),
                      r.standard_normal((1, 12)).astype(np.float32)))
    return items


@pytest.mark.parametrize("acw", [0, 2])
def test_batcher_matches_jax(acw):
    """Same seed, same utterances: the same crops as the JAX batcher."""
    items = _utterances()
    kw = dict(batch_size=3, batch_length=400, hop_size=HOP,
              aux_context_window=acw, seed=11)
    port = FastSVCBatcher(items, **kw)
    ref = JaxBatcher([it[1:] for it in items], **kw)
    for _ in range(3):
        got, want = port.sample_batch(), ref.sample_batch()
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), k)
