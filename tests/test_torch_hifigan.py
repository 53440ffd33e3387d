"""The port's HiFiGAN multi-scale + multi-period discriminator against the
JAX package's, on the CPU.

- Forward with `return_fmaps` (every logit map and activation) from JAX's
  weights through `hifigan_msd_mpd_state_dict_from_jax`, on a signal whose
  length no period divides (the reflect pad), within 1e-5 of max |y|; the
  port's `state_dict()` loads back into JAX through
  `convert_hifigan_msd_mpd` bit for bit.
- `config.build_discriminator` at JAX `from_config`'s defaults: the same
  tree of parameter shapes as the JAX model's (3 scales, periods 2, 3, 5,
  7, 11), plain scale convs and weight-normed period convs.
- `feature_matching_loss` against JAX's.
- One FastSVC `gan_step` with it, at tests/test_train_step.py's sizes,
  against JAX's on the same weights and batch (f32: the losses within
  test_torch_train.py's LOSS_TOL, D's update tensor by tensor).
- The window-conv plans take the full-width discriminator's stride-1
  convs (K = 15 at Cin 1 -> 128, K = 5 at 1024 -> 1024, K = 3 at
  1024 -> 1), and `ops.conv.conv1d` sends them to the window-conv kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svcc23_fastsvc_tpu.compat import convert_hifigan_msd_mpd
from svcc23_fastsvc_tpu.losses import feature_matching_loss as jax_fm
from svcc23_fastsvc_tpu.models.fastsvc import (
    HiFiGANMultiScaleMultiPeriodDiscriminator as JaxHiFiGAN,
)
from svcc23_fastsvc_tpu_torch.compat import hifigan_msd_mpd_state_dict_from_jax
from svcc23_fastsvc_tpu_torch.config import build_discriminator
from svcc23_fastsvc_tpu_torch.losses import feature_matching_loss
from svcc23_fastsvc_tpu_torch.models.fastsvc import (
    HiFiGANMultiScaleMultiPeriodDiscriminator,
)
from svcc23_fastsvc_tpu_torch.ops import conv as tconv
from svcc23_fastsvc_tpu_torch.ops import window_conv as wc
from svcc23_fastsvc_tpu_torch.train.gan import FastSVCTrainTask
from svcc23_fastsvc_tpu_torch.train.state import RefRAdam
from test_torch_train import LOSS_TOL, _batch, _rel_err, _tasks

# tests/test_train_step.py:222's discriminator
SMALL = dict(scales=2, periods=(2, 3),
             scale_params={"channels": 16, "max_downsample_channels": 32,
                           "max_groups": 4, "downsample_scales": [2, 2]},
             period_params={"channels": 4, "max_downsample_channels": 16,
                            "downsample_scales": [3, 1]})


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(seed=0):
    jd = JaxHiFiGAN(**SMALL)
    params = jd.init(jax.random.PRNGKey(seed))
    port = HiFiGANMultiScaleMultiPeriodDiscriminator(**SMALL)
    port.load_state_dict(hifigan_msd_mpd_state_dict_from_jax(_np(params)))
    return jd, params, port


def test_forward_with_fmaps_matches_jax_and_converts_back():
    jd, params, port = _pair()
    x = 0.3 * np.random.default_rng(1).standard_normal((2, 401, 1)).astype(
        np.float32)
    outs, fmaps = jd.apply(params, jnp.asarray(x), return_fmaps=True)
    with torch.no_grad():
        got, got_f = port(torch.from_numpy(x), return_fmaps=True)
        plain = port(torch.from_numpy(x))
    assert len(got) == len(outs) == 4 and len(got_f) == len(fmaps)
    for g, w in zip(got + got_f, list(outs) + list(fmaps)):
        assert tuple(g.shape) == w.shape
        assert _rel_err(g, w) < 1e-5
    assert all(torch.equal(a, b) for a, b in zip(plain, got))
    back = convert_hifigan_msd_mpd(
        {k: v.numpy() for k, v in port.state_dict().items()},
        scales=2, periods=(2, 3))
    flat_a, tree_a = jax.tree.flatten(params)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_build_discriminator_has_jax_default_shapes():
    cfg = {"discriminator_type": "HiFiGANMultiScaleMultiPeriodDiscriminator",
           "discriminator_params": {}}
    port = build_discriminator(cfg)
    want = jax.eval_shape(JaxHiFiGAN.from_config({}).init,
                          jax.random.PRNGKey(0))
    got = convert_hifigan_msd_mpd(
        {k: np.zeros(v.shape, np.float32)
         for k, v in port.state_dict().items()})
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape
    keys = set(port.state_dict())
    # the reference's quirk: plain scale convs, weight-normed period convs
    assert "msd.discriminators.0.layers.3.0.weight" in keys
    assert "msd.discriminators.2.last_layer.weight" in keys
    assert "mpd.discriminators.4.convs.4.0.weight_g" in keys
    assert "mpd.discriminators.4.output_conv.weight_v" in keys
    assert not any(k.startswith("msd") and "weight_g" in k for k in keys)
    assert [d.period for d in port.mpd.discriminators] == [2, 3, 5, 7, 11]
    assert [d.negative_slope for d in port.mpd.discriminators] == [0.1] * 5


def test_feature_matching_loss_matches_jax():
    r = np.random.default_rng(2)
    a = [r.standard_normal(s).astype(np.float32) for s in ((2, 9, 4), (2, 5))]
    b = [r.standard_normal(x.shape).astype(np.float32) for x in a]
    got = feature_matching_loss([torch.from_numpy(x) for x in a],
                                [torch.from_numpy(x) for x in b])
    assert _rel_err(got, jax_fm([jnp.asarray(x) for x in a],
                                [jnp.asarray(x) for x in b])) < 1e-6


def test_gan_step_with_hifigan_matches_jax():
    import dataclasses

    jtask0, _, base = _tasks(None)
    jd, dparams, port_d = _pair(seed=3)
    jtask = dataclasses.replace(jtask0, discriminator=jd)
    state = jtask.init_state(jax.random.PRNGKey(6))
    state = state.replace(d_params=dparams,
                          d_opt_state=jtask.d_tx.init(dparams))
    task = FastSVCTrainTask(
        generator=base.generator, discriminator=port_d, g_opt=base.g_opt,
        d_opt=RefRAdam(port_d.parameters(), lr=1e-3, grad_norm=1.0),
        signal_generator=base.signal_generator, stft_loss=base.stft_loss,
        rng=torch.Generator().manual_seed(0))
    d0 = {k: v.clone() for k, v in port_d.state_dict().items()}
    batch = _batch(31)
    state, jm = jax.jit(jtask.gan_step)(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    tm = task.gan_step({k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(tm) == set(jm)
    for k in jm:
        assert _rel_err(tm[k], jm[k]) < LOSS_TOL[None], k
    want = hifigan_msd_mpd_state_dict_from_jax(_np(state.d_params))
    for k, v in port_d.state_dict().items():
        moved = (want[k] - d0[k]).abs().max().item()
        err = (v - want[k]).abs().max().item()
        assert err <= 2e-3 * moved + 4e-7 * v.abs().max().item(), k


@pytest.mark.parametrize("B,T,K,cin,cout", [
    (64, 16000, 15, 1, 128), (64, 250, 5, 1024, 1024),
    (64, 250, 3, 1024, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_conv_plans_take_the_full_width_shapes(B, T, K, cin, cout,
                                                      dtype, monkeypatch):
    """fwd_plan (forward, and dx as Cout -> Cin) and wgrad_plan give valid
    instances at the full-width discriminator's stride-1 convs (the gan
    step's 2B = 64 real | fake rows at scale 0), and conv1d routes them to
    the window conv."""
    assert max(cin, cout) <= tconv.WINDOW_CONV_MAX_CHANNELS
    for a, b in ((cin, cout), (cout, cin)):
        p = wc.fwd_plan(dtype, B, T, a, b)
        if p["variant"] == "mma":
            assert (p["tm"], p["tn"]) in wc._FWD_MMA_TILES
        else:
            assert (p["tm"], p["tn"]) in wc._FWD_FFMA_TILES
    g = wc.wgrad_plan(dtype, B, T, K, cin, cout)
    assert g["n_slots"] >= 1
    assert g["n_slots"] * (K * cin * cout + cout) <= wc._WGRAD_MAX_WORDS
    assert g["n_islabs"] * g["ics"] >= cin
    seen = []
    monkeypatch.setattr(tconv, "window_conv",
                        lambda *a, **k: seen.append(a[1].shape))
    x = torch.zeros(1, 8, cin)
    with torch.no_grad():
        tconv.conv1d(x, torch.zeros(K, cin, cout), padding=(K - 1) // 2)
    assert seen == [(K, cin, cout)]
