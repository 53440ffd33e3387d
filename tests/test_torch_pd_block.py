"""The port's gated-block ops (`ops/pd_block.py`) against the JAX package.

The plain versions of the two vocoder kernels are held, on the CPU, to the
JAX package's Pallas kernels (`ops/pallas_pd_block.py`, interpret mode off
the TPU) and to its XLA path (`models/hnusfgan.py`: pd_indexing_framewise
plus AdaptiveBlock.apply, FixedBlock.apply), on inputs made with numpy
from a seed; the wrappers take the plain versions for CPU tensors. Widths
as tests/test_pallas_pd_block.py: R 16, G 32, A 10, T 3200, hop 160.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svcc23_fastsvc_tpu.models import hnusfgan as jhn
from svcc23_fastsvc_tpu.ops import pallas_pd_block as jpd
from svcc23_fastsvc_tpu_torch.models.hnusfgan import (
    PD_HALO_FS,
    pd_indexing,
    pd_indexing_framewise,
)
from svcc23_fastsvc_tpu_torch.ops import pd_block

R, G, A = 16, 32, 10
TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _t(a, dtype=torch.float32):
    """numpy or JAX array -> torch, through f32 (exact for bf16 values)."""
    return torch.from_numpy(np.asarray(a, np.float32).copy()).to(dtype)


def _tree(params, dtype):
    return jax.tree.map(lambda a: _t(a, dtype), params)


def _inputs(seed, B, T, dtype, hop=160, d_lo=5.0, d_hi=35.0):
    r = np.random.default_rng(seed)
    x = jnp.asarray(r.standard_normal((B, T, R)), jnp.float32).astype(dtype)
    c = jnp.asarray(r.standard_normal((B, T, A)), jnp.float32).astype(dtype)
    d = np.repeat(r.uniform(d_lo, d_hi, (B, T // hop)), hop, axis=1)
    return x, c, jnp.asarray(d, jnp.float32)


def _adaptive_case(dil, dtype, seed, **kw):
    blk = jhn.AdaptiveBlock(residual_channels=R, gate_channels=G,
                            skip_channels=R, aux_channels=A,
                            use_weight_norm=False)
    params = jax.tree.map(lambda v: v.astype(dtype),
                          blk.init(jax.random.PRNGKey(seed)))
    return (blk, params) + _inputs(seed + 1, 2, 3200, dtype, **kw)


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dil,dtype,d_range", [
    (1, jnp.float32, (5.0, 35.0)),
    (4, jnp.float32, (5.0, 35.0)),
    (16, jnp.float32, (5.0, 35.0)),
    (4, jnp.bfloat16, (5.0, 35.0)),
    (16, jnp.float32, (100.0, 159.0)),  # shifts past both ends of the stream
])
def test_adaptive_plain_matches_jax_kernel_and_xla(dil, dtype, d_range):
    blk, params, x, c, d = _adaptive_case(dil, dtype, seed=dil,
                                          d_lo=d_range[0], d_hi=d_range[1])
    kernel = jhn._pd_fused_apply(params, x, c, d, dil, 160)
    xP, xF = jhn.pd_indexing_framewise(x, d, dil, 160)
    xla = blk.apply(params, x, xP, xF, c)
    tdt = TORCH[dtype]
    halo = pd_block.pd_block_halo(dil, PD_HALO_FS, hop=160)
    shifts = pd_block.frame_shifts(_t(d), dil, 160, halo)
    got = pd_block.pd_adaptive_block(_t(x, tdt), _t(c, tdt), shifts,
                                     _tree(params, tdt), hop=160)
    assert got.dtype == tdt and got.shape == x.shape
    tol = 2e-2 if dtype == jnp.bfloat16 else 2e-5
    _close(got, kernel, tol)
    _close(got, xla, tol)


@pytest.mark.parametrize("dil,dtype", [
    (1, jnp.float32),
    (64, jnp.float32),
    (4, jnp.bfloat16),
])
def test_fixed_plain_matches_jax_kernel_and_xla(dil, dtype):
    blk = jhn.FixedBlock(residual_channels=R, gate_channels=G,
                         skip_channels=R, aux_channels=A, dilation=dil,
                         use_weight_norm=False)
    params = jax.tree.map(lambda v: v.astype(dtype),
                          blk.init(jax.random.PRNGKey(dil)))
    x, c, _ = _inputs(dil + 5, 2, 3200, dtype)
    kernel = jhn._fixed_fused_apply(params, x, c, dil)
    xla = blk.apply(params, x, c)
    tdt = TORCH[dtype]
    got = pd_block.pd_fixed_block(_t(x, tdt), _t(c, tdt), _tree(params, tdt),
                                  dilation=dil)
    assert got.dtype == tdt and got.shape == x.shape
    tol = 2e-2 if dtype == jnp.bfloat16 else 2e-5
    _close(got, kernel, tol)
    _close(got, xla, tol)


def test_pd_indexing_and_framewise_match_jax():
    r = np.random.default_rng(3)
    B, C, hop, F = 2, 3, 10, 12
    T = hop * F
    x = r.standard_normal((B, T, C)).astype(np.float32)
    d_frame = r.uniform(0.3, 9.7, (B, F))
    d = np.repeat(d_frame, hop, axis=1).astype(np.float32)
    d_sample = r.uniform(0.3, 9.7, (B, T)).astype(np.float32)
    for dil in (1, 2, 4):
        for got, want in (
            (pd_indexing(_t(x), _t(d_sample), dil),
             jhn.pd_indexing(jnp.asarray(x), jnp.asarray(d_sample), dil)),
            (pd_indexing_framewise(_t(x), _t(d), dil, hop),
             jhn.pd_indexing_framewise(jnp.asarray(x), jnp.asarray(d), dil,
                                       hop)),
            # T % hop != 0 falls back to the per-sample gather
            (pd_indexing_framewise(_t(x[:, :-3]), _t(d[:, :-3]), dil, hop),
             jhn.pd_indexing_framewise(jnp.asarray(x[:, :-3]),
                                       jnp.asarray(d[:, :-3]), dil, hop)),
        ):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_halo_and_shift_clamp_match_jax():
    for dil in (1, 2, 4, 8, 16):
        for hop in (100, 160):
            assert pd_block.pd_block_halo(dil, 24000, hop=hop) == \
                jpd.pd_block_halo(dil, 24000, hop=hop)
    # f0 below the halo's 37.5 Hz floor is clamped, as in _pd_fused_apply
    d = torch.tensor([[24000 / (4 * 20.0)] * 160 + [2.5] * 160])
    halo = pd_block.pd_block_halo(16, 24000)
    shifts = pd_block.frame_shifts(d, 16, 160, halo)
    assert shifts.dtype == torch.int32
    assert shifts.tolist() == [[2720, 40]]


def test_wrappers_reject_what_the_kernels_do_not_take():
    _, params, x, c, d = _adaptive_case(1, jnp.float32, seed=0)
    p = _tree(params, torch.float32)
    shifts = torch.zeros((2, 20), dtype=torch.int32)
    with pytest.raises(ValueError):  # T not a multiple of hop
        pd_block.pd_adaptive_block(_t(x)[:, :3100], _t(c)[:, :3100],
                                   shifts, p, hop=160)
    with pytest.raises(ValueError):  # c of the wrong width
        pd_block.pd_adaptive_block(_t(x), _t(c)[..., :4], shifts, p, hop=160)
    fixed = {"conv": {"w": torch.zeros(3, R, G), "b": torch.zeros(G)},
             "aux": {"w": torch.zeros(1, A, G)},
             "out": {"w": torch.zeros(1, G // 2, R), "b": torch.zeros(R)}}
    with pytest.raises(ValueError):  # reflection needs T > dilation
        pd_block.pd_fixed_block(_t(x)[:, :64], _t(c)[:, :64], fixed,
                                dilation=64)
