"""PyTorch port's resample and conv primitives against the JAX package.

Inputs are made with numpy from a seed and go through both. The window
conv's plain version is held against the TPU kernel (`window_conv_fwd`, in
interpret mode off the TPU) and against the JAX `conv1d`. The CUDA kernel
is held against the plain version in tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from svcc23_fastsvc_tpu.ops import conv as jconv
from svcc23_fastsvc_tpu.ops import resample as jres
from svcc23_fastsvc_tpu.ops.pallas_window_conv import window_conv_fwd
from svcc23_fastsvc_tpu_torch.ops import conv as tconv
from svcc23_fastsvc_tpu_torch.ops import resample as tres
from svcc23_fastsvc_tpu_torch.ops.window_conv import (
    window_conv,
    window_conv_plain,
)


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("T,out", [(12, 36), (36, 12), (10, 7), (7, 10), (9, 9)])
def test_nearest_resize_matches_jax(T, out):
    x = _rng().standard_normal((2, T, 3)).astype(np.float32)
    want = np.asarray(jres.nearest_resize(jnp.asarray(x), out))
    got = tres.nearest_resize(torch.from_numpy(x), out).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scale", [1, 2, 5])
def test_nearest_up_and_downsample_match_jax(scale):
    x = _rng(1).standard_normal((2, 20, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        tres.nearest_upsample(torch.from_numpy(x), scale).numpy(),
        np.asarray(jres.nearest_upsample(jnp.asarray(x), scale)))
    np.testing.assert_array_equal(
        tres.nearest_downsample(torch.from_numpy(x), scale).numpy(),
        np.asarray(jres.nearest_downsample(jnp.asarray(x), scale)))


def test_elementwise_and_norm_primitives_match_jax():
    r = _rng(2)
    x = r.standard_normal((2, 50, 6)).astype(np.float32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    np.testing.assert_allclose(tconv.leaky_relu(tx, 0.2).numpy(),
                               np.asarray(jconv.leaky_relu(jx, 0.2)), rtol=1e-6)
    np.testing.assert_allclose(tconv.instance_norm(tx).numpy(),
                               np.asarray(jconv.instance_norm(jx)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tconv.l2_normalize(tx).numpy(),
                               np.asarray(jconv.l2_normalize(jx)),
                               rtol=1e-6, atol=1e-7)
    lp = {"w": r.standard_normal((6, 5)).astype(np.float32),
          "b": r.standard_normal(5).astype(np.float32)}
    np.testing.assert_allclose(
        tconv.linear(tx, {k: torch.from_numpy(v) for k, v in lp.items()}).numpy(),
        np.asarray(jconv.linear(jx, {k: jnp.asarray(v) for k, v in lp.items()})),
        rtol=1e-5, atol=1e-5)


def test_weight_norm_helpers_match_jax():
    r = _rng(3)
    wn = {"v": r.standard_normal((3, 4, 5)).astype(np.float32),
          "g": r.uniform(0.5, 2, 5).astype(np.float32),
          "b": r.standard_normal(5).astype(np.float32)}
    tree = {"a": [wn, {"w": wn["v"]}], "c": wn}
    jt = jconv.fold_weight_norm(
        {"a": [{k: jnp.asarray(v) for k, v in wn.items()},
               {"w": jnp.asarray(wn["v"])}],
         "c": {k: jnp.asarray(v) for k, v in wn.items()}})
    tt = tconv.fold_weight_norm(
        {"a": [{k: torch.from_numpy(v) for k, v in d.items()}
               for d in tree["a"]],
         "c": {k: torch.from_numpy(v) for k, v in wn.items()}})
    for got, want in ((tt["a"][0], jt["a"][0]), (tt["a"][1], jt["a"][1]),
                      (tt["c"], jt["c"])):
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-7)
    tw = {k: torch.from_numpy(v) for k, v in wn.items()}
    np.testing.assert_allclose(
        tconv.conv_weight(tw).numpy(),
        np.asarray(jconv.conv_weight({k: jnp.asarray(v) for k, v in wn.items()})),
        rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        tconv.conv_weight({"w": tw["v"]}).numpy(), wn["v"])


def _conv_case(B, T, Cin, Cout, K, seed):
    r = _rng(seed)
    x = r.standard_normal((B, T, Cin)).astype(np.float32)
    w = (r.standard_normal((K, Cin, Cout)) * 0.3).astype(np.float32)
    b = r.standard_normal(Cout).astype(np.float32)
    return x, w, b


# B, T, Cin, Cout, K, dilation, slope, bias
WINDOW_CASES = [
    (2, 131, 1, 8, 3, 1, 0.2, True),      # first down block: one input channel
    (2, 131, 8, 12, 3, 3, None, True),
    (1, 97, 12, 8, 3, 27, 0.2, False),    # dilation near T/4, edge heavy
    (2, 75, 6, 6, 3, 9, 0.2, True),
    (1, 61, 5, 7, 5, 2, 0.2, True),       # K = 5
]


@pytest.mark.parametrize("B,T,Cin,Cout,K,dil,slope,bias", WINDOW_CASES)
def test_window_conv_plain_matches_tpu_kernel_and_jax_conv(
        B, T, Cin, Cout, K, dil, slope, bias):
    x, w, b = _conv_case(B, T, Cin, Cout, K, seed=T + dil)
    lo = (K - 1) // 2 * dil
    got = window_conv(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(b) if bias else None, dil, slope).numpy()
    jb = jnp.asarray(b) if bias else None
    kern = np.asarray(window_conv_fwd(jnp.asarray(x), jnp.asarray(w), jb, lo,
                                      dil, slope))
    ref = np.asarray(jconv.conv1d(jnp.asarray(x), jnp.asarray(w), jb,
                                  padding=lo, dilation=dil, input_leaky=slope))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, kern, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * scale)


def test_window_conv_plain_bf16_matches_tpu_kernel():
    x, w, b = _conv_case(2, 90, 8, 8, 3, seed=5)
    xb, wb, bb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w, b))
    got = window_conv_plain(xb, wb, bb, 3, 0.2)
    assert got.dtype == torch.bfloat16
    kern = np.asarray(window_conv_fwd(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (xb, wb, bb)), 3, 3, 0.2).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), kern, rtol=0,
                               atol=2e-2 * np.abs(kern).max())


@pytest.mark.parametrize("padding,dil", [(1, 1), (9, 9)])
def test_conv1d_dispatch_matches_jax(padding, dil):
    x, w, b = _conv_case(2, 40, 6, 5, 3, seed=9)
    got = tconv.conv1d(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(b), padding=padding, dilation=dil,
                       input_leaky=0.2).numpy()
    want = np.asarray(jconv.conv1d(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b), padding=padding,
                                   dilation=dil, input_leaky=0.2))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_conv1d_pointwise_matches_jax():
    x, w, b = _conv_case(2, 40, 6, 5, 1, seed=10)
    got = tconv.conv1d(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(b)).numpy()
    want = np.asarray(jconv.conv1d(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_conv1d_rejects_convs_outside_the_decode_subset():
    # convs outside the window-conv subset (here not "same"-padded) now go
    # to F.conv1d and match the JAX conv; a padding spec conv1d does not
    # take is still rejected
    x, w, b = _conv_case(1, 20, 4, 4, 3, seed=11)
    got = tconv.conv1d(torch.from_numpy(x), torch.from_numpy(w),
                       padding=2).numpy()
    want = np.asarray(jconv.conv1d(jnp.asarray(x), jnp.asarray(w),
                                   padding=2))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        tconv.conv1d(torch.from_numpy(x), torch.from_numpy(w), padding="SAME")


def test_window_conv_raises_off_cpu_instead_of_falling_back():
    x = torch.zeros((1, 8, 4), device="meta")
    w = torch.zeros((3, 4, 4), device="meta")
    with pytest.raises(ValueError):
        window_conv(x, w, None, 1, 0.2)


# the discriminator's primitives: strided and grouped convs with int,
# (lo, hi) and "VALID" padding, avg pooling without the padded elements in
# the count, reflection padding; f32, 1e-5
@pytest.mark.parametrize("K,stride,padding,groups,cin,cout", [
    (41, 4, 20, 4, 16, 64),
    (15, 1, "VALID", 1, 1, 16),
    (5, 2, (1, 3), 2, 8, 6),
    (3, 1, 1, 1, 8, 8),
])
def test_conv1d_strided_grouped_matches_jax(K, stride, padding, groups, cin,
                                            cout):
    r = _rng(12)
    x = r.standard_normal((2, 97, cin)).astype(np.float32)
    w = r.standard_normal((K, cin // groups, cout)).astype(np.float32)
    b = r.standard_normal(cout).astype(np.float32)
    got = tconv.conv1d(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(b), stride=stride, padding=padding,
                       groups=groups).numpy()
    want = np.asarray(jconv.conv1d(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b), stride=stride,
                                   padding=padding, groups=groups))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("T,k,s,p,include", [
    (100, 4, 2, 1, False), (33, 4, 2, 1, False), (33, 3, 3, 0, True),
])
def test_avg_pool1d_and_reflect_pad1d_match_jax(T, k, s, p, include):
    x = _rng(13).standard_normal((2, T, 3)).astype(np.float32)
    got = tconv.avg_pool1d(torch.from_numpy(x), k, s, p,
                           count_include_pad=include).numpy()
    want = np.asarray(jconv.avg_pool1d(jnp.asarray(x), k, s, p,
                                       count_include_pad=include))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    for pad in (7, (2, 5)):
        np.testing.assert_array_equal(
            tconv.reflect_pad1d(torch.from_numpy(x), pad).numpy(),
            np.asarray(jconv.reflect_pad1d(jnp.asarray(x), pad)))
