"""The port's B02 Tacotron2 (`models/tacotron2.py`) against the JAX package's.

The primitives (LSTM cell, `bilstm` with lengths, eval batch norm, the
global instance norm, dropout with given masks) against JAX's; a small
Tacotron2, free-running with JAX's prenet dropout masks (rebuilt from its
key splits), against `Tacotron2.apply(..., train=False)` in f32 and bf16;
the fused-conv calls its forward makes under `FASTSVC_PALLAS_CONV=1`
against JAX's; the weight converter both ways. Weights go JAX init ->
`tacotron2_state_dict_from_jax` -> the port; inputs are made with numpy
from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svcc23_fastsvc_tpu.compat import convert_tacotron2
from svcc23_fastsvc_tpu.models import tacotron2 as jt
from svcc23_fastsvc_tpu.ops import conv as jconv
from svcc23_fastsvc_tpu.ops import pallas_conv as jpc
from svcc23_fastsvc_tpu_torch.compat import tacotron2_state_dict_from_jax
from svcc23_fastsvc_tpu_torch.config import build_acoustic_model
from svcc23_fastsvc_tpu_torch.models import tacotron2 as tt
from svcc23_fastsvc_tpu_torch.ops import conv as tconv
from svcc23_fastsvc_tpu_torch.ops import fused_conv as fc

SMALL = dict(input_dim=16, output_dim=10, hidden_dim=32, dec_layers=2,
             spk_emb_dim=8, econv_chans=16, prenet_dim=8)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree, dtype=torch.float32):
    return jax.tree.map(
        lambda a: torch.from_numpy(np.asarray(a, np.float32).copy()).to(dtype),
        tree)


def _params(seed=0, **kw):
    """JAX init with non-trivial batch-norm running statistics."""
    model = jt.Tacotron2(**{**SMALL, **kw})
    p = model.init(jax.random.PRNGKey(seed))
    r = np.random.default_rng(seed + 100)

    def stats(bn):
        n = bn["mean"].shape[0]
        return {**bn, "mean": jnp.asarray(r.normal(0, 0.3, n), jnp.float32),
                "var": jnp.asarray(r.uniform(0.5, 2.0, n), jnp.float32),
                "w": jnp.asarray(r.uniform(0.5, 1.5, n), jnp.float32),
                "b": jnp.asarray(r.normal(0, 0.1, n), jnp.float32)}

    for cp in p["encoder"]["convs"]:
        cp["bn"] = stats(cp["bn"])
    p["bap_decoder"]["bn"] = stats(p["bap_decoder"]["bn"])
    return model, p


def _port(params, **kw):
    model = tt.Tacotron2(**{**SMALL, **kw})
    model.load_state_dict(tacotron2_state_dict_from_jax(_np(params)))
    return model.eval()


def _inputs(B, T, seed=1, D=16, S=8):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, T, D)).astype(np.float32),
            r.standard_normal((B, T, 1)).astype(np.float32),
            r.standard_normal((B, T, 1)).astype(np.float32),
            r.standard_normal((B, S)).astype(np.float32))


def jax_prenet_masks(key, T, B, layers, dim, rate=0.5):
    """The keep masks JAX's free-running decoder draws from `key`:
    split(key, 3) -> k_pre; split(k_pre, T); per layer key, sub = split(key);
    bernoulli(sub, 1 - rate, (B, dim)). -> (T, layers, B, dim) bool."""
    _, k_pre, _ = jax.random.split(key, 3)
    out = []
    for kp in jax.random.split(k_pre, T):
        row = []
        for _ in range(layers):
            kp, sub = jax.random.split(kp)
            row.append(np.asarray(jax.random.bernoulli(sub, 1.0 - rate,
                                                       (B, dim))))
        out.append(row)
    return torch.from_numpy(np.array(out))


def test_lstm_cell_matches_jax():
    r = np.random.default_rng(0)
    p = {"w_ih": r.standard_normal((6, 20)), "w_hh": r.standard_normal((5, 20)),
         "b_ih": r.standard_normal(20), "b_hh": r.standard_normal(20)}
    x, h, c = (r.standard_normal(s) for s in ((3, 6), (3, 5), (3, 5)))
    want = jt.lstm_cell(jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), p),
                        *(jnp.asarray(a, jnp.float32) for a in (x, h, c)))
    got = tt.lstm_cell(_t(p), *_t((x, h, c)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("lengths", [None, [9, 4, 1]])
def test_bilstm_matches_jax(lengths):
    r = np.random.default_rng(1)
    cell = lambda: {"w_ih": 0.3 * r.standard_normal((6, 16)),  # noqa: E731
                    "w_hh": 0.3 * r.standard_normal((4, 16)),
                    "b_ih": r.standard_normal(16), "b_hh": r.standard_normal(16)}
    p = {"fwd": cell(), "bwd": cell()}
    xs = r.standard_normal((3, 9, 6))
    jl = None if lengths is None else jnp.asarray(lengths)
    want = np.asarray(jt.bilstm(jax.tree.map(
        lambda a: jnp.asarray(a, jnp.float32), p), jnp.asarray(xs, jnp.float32),
        jl))
    got = tt.bilstm(_t(p), _t(xs),
                    None if lengths is None else torch.tensor(lengths))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    if lengths is not None:  # zeros past each length, as packed sequences
        assert not got[2, 1:].any() and not got[1, 4:].any()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_norms_match_jax(dtype):
    r = np.random.default_rng(2)
    x = jnp.asarray(r.standard_normal((2, 7, 5)) * 3 + 1, dtype)
    p = {"w": r.uniform(0.5, 1.5, 5), "b": r.normal(0, 0.1, 5),
         "mean": r.normal(0, 0.3, 5), "var": r.uniform(0.5, 2, 5)}
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    jp = jax.tree.map(lambda a: jnp.asarray(a, dtype), p)
    want_bn, _ = jt.batch_norm(x, jp, train=False)
    want_in = jt.instance_norm_global(x)
    xt = _t(x, tdt)
    got_bn = tt.batch_norm(xt, _t(jp, tdt))
    got_in = tt.instance_norm_global(xt)
    for got, want in ((got_bn, want_bn), (got_in, want_in)):
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=1e-5 if dtype == jnp.float32 else 1e-2,
                                   atol=1e-5 if dtype == jnp.float32 else 1e-2)


def test_dropout_with_jax_masks_matches_jax():
    x = jnp.asarray(np.random.default_rng(3).standard_normal((4, 6)),
                    jnp.float32)
    key = jax.random.PRNGKey(5)
    want = jt.dropout(key, x, 0.5, train=True)
    keep = torch.from_numpy(np.array(jax.random.bernoulli(key, 0.5,
                                                          x.shape)))
    got = tt.dropout(_t(x), 0.5, keep)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tt.dropout(_t(x), 0.5, keep, train=False) is not None


def _jax_decode(model, params, ins, lengths, key, dtype=jnp.float32):
    feats, lft, lf0, emb = (jnp.asarray(a, dtype) for a in ins)
    p = jax.tree.map(lambda a: a.astype(dtype) if a.dtype == jnp.float32
                     else a, params)
    fwd = jax.jit(lambda p, *a: model.apply(p, *a, train=False, key=key)[0])
    jl = None if lengths is None else jnp.asarray(lengths)
    return np.asarray(fwd(p, feats, jl, lft, lf0, emb), np.float32)


@pytest.mark.parametrize("lengths", [None, [20, 13]])
def test_free_running_decode_matches_jax(lengths):
    model, params = _params()
    ins = _inputs(2, 20)
    key = jax.random.PRNGKey(3)
    want = _jax_decode(model, params, ins, lengths, key)
    port = _port(params)
    masks = jax_prenet_masks(key, 20, 2, 2, 8)
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in ins[:1]),
                   None if lengths is None else torch.tensor(lengths),
                   *(torch.from_numpy(a) for a in ins[1:]),
                   prenet_masks=masks)
    assert got.shape == want.shape == (2, 20, 13)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_free_running_decode_in_bf16_matches_jax():
    """bf16 parameters (batch-norm statistics too) and inputs, as decode_b02
    casts them. Both packages round after every op, in other orders inside
    the matmuls, and the 20 fed-back frames carry the difference: within
    2e-2 of max |y| (measured 0.62%; JAX's own bf16 output is 1.25% from
    its f32 one)."""
    model, params = _params()
    ins = _inputs(2, 20)
    key = jax.random.PRNGKey(3)
    want = _jax_decode(model, params, ins, [20, 13], key, jnp.bfloat16)
    want32 = _jax_decode(model, params, ins, [20, 13], key)
    port = _port(params).to(torch.bfloat16)
    masks = jax_prenet_masks(key, 20, 2, 2, 8)
    with torch.no_grad():
        got = port(torch.from_numpy(ins[0]).bfloat16(), torch.tensor([20, 13]),
                   *(torch.from_numpy(a).bfloat16() for a in ins[1:]),
                   prenet_masks=masks)
    assert got.dtype == torch.bfloat16
    scale = np.abs(want32).max()
    err = np.abs(got.float().numpy() - want).max()
    own = np.abs(want - want32).max()
    assert err <= 2e-2 * scale, (err / scale, own / scale)


def test_generator_draws_prenet_masks():
    _, params = _params()
    port = _port(params)
    ins = [torch.from_numpy(a) for a in _inputs(1, 6)]
    with torch.no_grad():
        a = port(ins[0], None, *ins[1:],
                 generator=torch.Generator().manual_seed(4))
        b = port(ins[0], None, *ins[1:],
                 generator=torch.Generator().manual_seed(4))
        masks = port.prenet_masks(6, 1, generator=torch.Generator()
                                  .manual_seed(4))
        c = port(ins[0], None, *ins[1:], prenet_masks=masks)
    assert masks.shape == (6, 2, 1, 8) and masks.dtype == torch.bool
    assert torch.equal(a, b) and torch.equal(a, c)


def test_fused_conv_calls_under_the_switch_match_jax(monkeypatch):
    """At T >= 256 every conv of at most 192 channels that the rule takes
    goes to the fused conv, in both packages: at this width the encoder's
    three K = 5 convs, the bap stream's conv0, conv1 and conv3 and the six
    K = 3 convs of the two 1-channel FiLM nets, 12 calls. At full width
    (encoder 512 channels, bap conv0 258 -> 86) JAX makes 8: the bap
    stream's conv1 (86 -> 43) and conv3 (21 -> 3), and the FiLM convs. The
    output equals the window-conv lowering's within f32 rounding."""
    seen = {"jax": [], "port": []}
    jfwd, tfwd = jpc.pallas_conv1d, fc.fused_conv1d

    def jspy(x, w, *a):
        seen["jax"].append(tuple(w.shape))
        return jfwd(x, w, *a)

    def tspy(x, w, *a, **kw):
        seen["port"].append(tuple(w.shape))
        return tfwd(x, w, *a, **kw)

    monkeypatch.setattr(jpc, "pallas_conv1d", jspy)
    monkeypatch.setattr(fc, "fused_conv1d", tspy)
    model, params = _params()
    ins = _inputs(1, 256)
    saved = (jconv._PALLAS_CONV_MODE, tconv._PALLAS_CONV_MODE)
    try:
        jconv.set_pallas_conv_mode("1")
        jax.make_jaxpr(lambda p, *a: model.apply(p, *a, train=False))(
            params, jnp.asarray(ins[0]), None, *map(jnp.asarray, ins[1:]))
        port = _port(params)
        masks = port.prenet_masks(256, 1, generator=torch.Generator()
                                  .manual_seed(0))
        args = [torch.from_numpy(ins[0]), None,
                *(torch.from_numpy(a) for a in ins[1:])]
        tconv.set_pallas_conv_mode("1")
        with torch.no_grad():
            on = port(*args, prenet_masks=masks)
            tconv.set_pallas_conv_mode("0")
            off = port(*args, prenet_masks=masks)
    finally:
        jconv.set_pallas_conv_mode(saved[0])
        tconv.set_pallas_conv_mode(saved[1])
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 12
    assert seen["port"].count((3, 1, 1)) == 6
    assert seen["port"].count((5, 16, 16)) == 3
    assert {(3, 18, 6), (3, 6, 3), (3, 1, 3)} <= set(seen["port"])
    np.testing.assert_allclose(on.numpy(), off.numpy(), rtol=0,
                               atol=1e-5 * off.abs().max().item())
    # full width, traced only
    seen["jax"].clear()
    full = jt.Tacotron2()
    shapes = jax.eval_shape(full.init, jax.random.PRNGKey(0))
    f32 = jax.ShapeDtypeStruct
    saved = jconv._PALLAS_CONV_MODE
    try:
        jconv.set_pallas_conv_mode("1")
        jax.make_jaxpr(lambda p, *a: full.apply(p, *a, train=False))(
            shapes, f32((1, 400, 256), jnp.float32), None,
            f32((1, 400, 1), jnp.float32), f32((1, 400, 1), jnp.float32),
            f32((1, 512), jnp.float32))
    finally:
        jconv.set_pallas_conv_mode(saved)
    assert sorted(seen["jax"]) == [(3, 1, 1)] * 6 + [(3, 21, 3), (3, 86, 43)]


def test_converter_round_trips():
    """JAX params -> the port's state dict -> the JAX package's
    convert_tacotron2 gives the same params; the state dict holds the
    reference keys that converter reads and loads strictly."""
    _, params = _params(seed=2)
    sd = tacotron2_state_dict_from_jax(_np(params))
    port = tt.Tacotron2(**SMALL)
    port.load_state_dict(sd)
    back = convert_tacotron2({k: v.numpy() for k, v in
                              port.state_dict().items()})
    flat_a, tree_a = jax.tree.flatten(params)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_build_acoustic_model_reads_the_b02_keys():
    cfg = {"generator_params": {**SMALL, "multi_speaker": True,
                                "integrate_logf0": True, "enc_layers": 1,
                                "ar_mode": True}}
    model = build_acoustic_model(cfg, generator=torch.Generator()
                                 .manual_seed(0))
    want = set(tacotron2_state_dict_from_jax(_np(_params()[1])))
    assert set(model.state_dict()) == want
    assert model.proj.weight.shape == (10, 32)
    full = build_acoustic_model({"generator_params": {"input_dim": 256}})
    assert full.bap_decoder[0].weight.shape == (86, 258, 3)
    assert full.decs[0].cell.weight_ih.shape == (4096, 1024 + 256)
