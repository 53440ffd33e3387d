"""The port's window-conv backward against the JAX package's, on the CPU.

`window_conv_dx_plain` and `window_conv_wgrad_plain` (what the CUDA dx and
wgrad kernels are held to) against the TPU kernels `window_conv_dx` and
`window_conv_wgrad` in interpret mode; the autograd Function `WindowConv1d`
against `jax.vjp` of `ops/conv.py::window_conv1d` and against autograd
through the plain forward. Inputs are made with numpy from a seed. The
tolerance is relative to each tensor's max |ref|: 1e-5 in f32 and 6e-3 in
bf16 (one bf16 rounding of values near the max), as tests/test_window_conv.py
holds the JAX kernels to their einsum reference.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svcc23_fastsvc_tpu.ops import conv as jconv
from svcc23_fastsvc_tpu.ops import pallas_window_conv as jwin
from svcc23_fastsvc_tpu_torch.models.fastsvc import Conv1d
from svcc23_fastsvc_tpu_torch.ops import conv as tconv
from svcc23_fastsvc_tpu_torch.ops import window_conv as twin


@pytest.fixture(autouse=True)
def _force_window_mode():
    jconv.set_window_conv_mode("1")
    yield
    jconv.set_window_conv_mode("0")


CASES = [
    # B, T, Cin, Cout, dil, slope, dtype
    (2, 700, 24, 24, 3, 0.2, "f32"),    # the generator's 24-channel class
    (1, 130, 8, 16, 27, None, "f32"),   # dilation ~ T/4, edge-heavy
    (2, 512, 48, 48, 9, 0.2, "bf16"),   # bf16 training class
    (1, 33, 4, 4, 1, 0.2, "f32"),       # tiny T, partial tiles
    (2, 96, 128, 128, 1, None, "f32"),  # the JAX channel gate
    (1, 64, 192, 192, 1, 0.2, "f32"),   # the generator's widest conv
]
IDS = [f"{c[0]}x{c[1]}x{c[2]}-{c[3]}-d{c[4]}-{c[6]}" for c in CASES]
TOL = {"f32": 1e-5, "bf16": 6e-3}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _case(B, T, cin, cout, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, T, cin)).astype(np.float32),
            (0.3 * r.standard_normal((3, cin, cout))).astype(np.float32),
            r.standard_normal(cout).astype(np.float32),
            r.standard_normal((B, T, cout)).astype(np.float32))


def _close(got, want, tol, name):
    got = np.asarray(torch.as_tensor(got).float().detach().numpy()
                     if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    scale = max(np.abs(want).max(), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=name)


@pytest.mark.parametrize("B,T,cin,cout,dil,slope,dt", CASES, ids=IDS)
def test_plain_dx_and_wgrad_match_tpu_kernels(B, T, cin, cout, dil, slope,
                                              dt):
    x, w, _, g = _case(B, T, cin, cout, seed=T + cin)
    tx, tw, tg = (torch.from_numpy(a).to(TDT[dt]) for a in (x, w, g))
    jx, jw, jg = (jnp.asarray(a).astype(JDT[dt]) for a in (x, w, g))
    _close(twin.window_conv_dx_plain(tg, tw, dil),
           jwin.window_conv_dx(jg, jw, dil, dil), TOL[dt], "dx")
    dw, db = twin.window_conv_wgrad_plain(tx, tg, 3, dil, slope)
    jdw, jdb = jwin.window_conv_wgrad(jx, jg, 3, dil, dil, slope, cout)
    assert dw.dtype == db.dtype == torch.float32
    _close(dw, jdw, TOL[dt], "dw")
    _close(db, jdb, TOL[dt], "db")


@pytest.mark.parametrize("B,T,cin,cout,dil,slope,dt", CASES, ids=IDS)
def test_window_conv_function_matches_jax_vjp(B, T, cin, cout, dil, slope,
                                              dt):
    x, w, b, g = _case(B, T, cin, cout, seed=2 * T + cout)
    jargs = [jnp.asarray(a).astype(JDT[dt]) for a in (x, w, b)]
    out, vjp = jax.vjp(
        lambda x, w, b: jconv.window_conv1d(x, w, b, dil, dil, slope), *jargs)
    want = (out, *vjp(jnp.asarray(g).astype(out.dtype)))

    targs = [torch.from_numpy(a).to(TDT[dt]).requires_grad_()
             for a in (x, w, b)]
    y = twin.WindowConv1d.apply(*targs, dil, slope)
    grads = torch.autograd.grad(y, targs, torch.from_numpy(g).to(TDT[dt]))
    for name, got, ref in zip(("y", "dx", "dw", "db"), (y, *grads), want):
        assert got.dtype == TDT[dt], name
        _close(got, ref, TOL[dt], name)


@pytest.mark.parametrize("B,T,cin,cout,dil,slope,dt", CASES, ids=IDS)
def test_window_conv_function_matches_autograd_of_plain(B, T, cin, cout, dil,
                                                        slope, dt):
    x, w, b, g = _case(B, T, cin, cout, seed=3 * T + cin)
    gt = torch.from_numpy(g).to(TDT[dt])

    def run(fn):
        args = [torch.from_numpy(a).to(TDT[dt]).requires_grad_()
                for a in (x, w, b)]
        y = fn(*args, dil, slope)
        return (y, *torch.autograd.grad(y, args, gt))

    want = run(twin.window_conv_plain)
    got = run(twin.WindowConv1d.apply)
    for name, a, ref in zip(("y", "dx", "dw", "db"), got, want):
        _close(a, ref.detach().float().numpy(), TOL[dt], name)


def test_backward_skips_dx_when_the_input_needs_no_grad(monkeypatch):
    calls = []
    real = twin.window_conv_dx
    monkeypatch.setattr(twin, "window_conv_dx",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x, w, b, g = (torch.from_numpy(a) for a in _case(1, 40, 4, 6, seed=5))
    w.requires_grad_()
    y = twin.WindowConv1d.apply(x, w, b, 2, 0.2)
    (dw,) = torch.autograd.grad(y, [w], g)
    assert calls == [] and dw.shape == w.shape
    x.requires_grad_()
    y = twin.WindowConv1d.apply(x, w, b, 2, 0.2)
    torch.autograd.grad(y, [x, w], g)
    assert calls == [1]


def test_conv1d_takes_the_function_only_with_grad_enabled():
    x, w, b, _ = (torch.from_numpy(a) for a in _case(1, 50, 4, 6, seed=6))
    w.requires_grad_()
    y = tconv.conv1d(x, w, b, padding=3, dilation=3, input_leaky=0.2)
    assert type(y.grad_fn).__name__ == "WindowConv1dBackward"
    with torch.no_grad():
        y0 = tconv.conv1d(x, w, b, padding=3, dilation=3, input_leaky=0.2)
    assert y0.grad_fn is None
    torch.testing.assert_close(y0, y.detach(), rtol=0, atol=0)


def test_weight_norm_grads_come_back_in_parameter_layout():
    """Conv1d.wio() is a permuted (K, I, O) view of (O, I, K) weight_v: its
    gradient from the window-conv Function lands in weight_v's own layout,
    equal to JAX's gradient of the WIO v (transposed)."""
    gen = torch.Generator().manual_seed(0)
    conv = Conv1d(6, 5, 3, generator=gen)
    r = np.random.default_rng(7)
    x = r.standard_normal((2, 40, 6)).astype(np.float32)
    g = r.standard_normal((2, 40, 5)).astype(np.float32)
    y = conv(torch.from_numpy(x), dilation=2, input_leaky=0.2)
    params = [conv.weight_v, conv.weight_g, conv.bias]
    grads = torch.autograd.grad(y, params, torch.from_numpy(g))
    assert [tuple(t.shape) for t in grads] == [tuple(p.shape) for p in params]

    jp = {"v": jnp.asarray(conv.weight_v.detach().numpy().transpose(2, 1, 0)),
          "g": jnp.asarray(conv.weight_g.detach().numpy().reshape(-1)),
          "b": jnp.asarray(conv.bias.detach().numpy())}

    def f(p):
        return jconv.window_conv1d(jnp.asarray(x), jconv.wn_weight(p),
                                   p["b"], 2, 2, 0.2)

    out, vjp = jax.vjp(f, jp)
    (jg,) = vjp(jnp.asarray(g))
    _close(y, out, 1e-5, "y")
    _close(grads[0], np.asarray(jg["v"]).transpose(2, 1, 0), 1e-5, "weight_v")
    _close(grads[1], np.asarray(jg["g"]).reshape(-1, 1, 1), 1e-5, "weight_g")
    _close(grads[2], jg["b"], 1e-5, "bias")
