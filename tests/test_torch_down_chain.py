"""The port's fused DownsampleBlock forward (`ops/down_chain.py`) against the
JAX package.

`down_chain_fwd_plain` is held, on the CPU, to the JAX package's Pallas
kernel (`ops/pallas_down_chain.py::down_chain_fwd`, interpret mode off the
TPU, tile_target 256) at tests/test_down_chain.py's shapes; the port's
`DownsampleBlock` with the down-chain mode on to JAX
`DownsampleBlock.apply`; a small generator's forward with the mode on to
the same forward with it off. The shapes the JAX kernel refuses (T % 32,
T < 2 halo) are held to the unfused block. Inputs are made with numpy from
a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svcc23_fastsvc_tpu.models.fastsvc import DownsampleBlock as JaxBlock
from svcc23_fastsvc_tpu.ops import fold_weight_norm as jax_fold
from svcc23_fastsvc_tpu.ops import pallas_down_chain as jdc
from svcc23_fastsvc_tpu_torch.compat import (
    downsample_block_state_dict_from_jax,
)
from svcc23_fastsvc_tpu_torch.models import fastsvc as tfs
from svcc23_fastsvc_tpu_torch.ops import down_chain as dc

TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _t(a, dtype=torch.float32):
    """numpy or JAX array -> torch, through f32 (exact for bf16 values)."""
    return torch.from_numpy(np.asarray(a, np.float32).copy()).to(dtype)


@pytest.fixture
def chain_on():
    dc.set_down_chain_mode("1")
    yield
    dc.set_down_chain_mode("0")


@pytest.fixture
def calls(monkeypatch):
    """The down-chain calls the model makes."""
    seen = []
    fwd = tfs.down_chain_fwd

    def spy(x, params, **kw):
        seen.append(tuple(x.shape))
        return fwd(x, params, **kw)

    monkeypatch.setattr(tfs, "down_chain_fwd", spy)
    return seen


def _port_block(jparams, cin, c, scale, weight_norm):
    blk = tfs.DownsampleBlock(cin, c, scale, use_weight_norm=weight_norm)
    blk.load_state_dict(downsample_block_state_dict_from_jax(
        jax.tree.map(np.asarray, jparams)))
    return blk.eval()


@pytest.mark.parametrize("cin,c,T,dtype", [
    (1, 24, 1600, jnp.float32),
    (24, 48, 960, jnp.float32),
    (24, 48, 960, jnp.bfloat16),
])
def test_plain_matches_jax_kernel(cin, c, T, dtype):
    blk = JaxBlock(cin, c, scale=1, use_weight_norm=True)
    params = jax.tree.map(lambda v: v.astype(dtype),
                          jax_fold(blk.init(jax.random.PRNGKey(0))))
    x = jnp.asarray(np.random.default_rng(1).standard_normal((2, T, cin)),
                    jnp.float32).astype(dtype)
    want = np.asarray(jdc.down_chain_fwd(x, params, tile_target=256),
                      np.float32)
    tdt = TORCH[dtype]
    got = dc.down_chain_fwd(_t(x, tdt),
                            jax.tree.map(lambda a: _t(a, tdt), params))
    assert got.dtype == tdt and got.shape == (2, T, c)
    tol = 3e-2 if dtype == jnp.bfloat16 else 2e-4
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("scale,folded", [(1, True), (4, False)])
def test_block_with_the_chain_matches_jax_block(chain_on, calls, scale,
                                                folded):
    blk = JaxBlock(24, 48, scale=scale, use_weight_norm=True)
    params = blk.init(jax.random.PRNGKey(2))
    if folded:
        params = jax_fold(params)
    x = np.random.default_rng(3).standard_normal((2, 960 * scale, 24)).astype(
        np.float32)
    want = np.asarray(blk.apply(params, jnp.asarray(x)))
    port = _port_block(params, 24, 48, scale, weight_norm=not folded)
    with torch.no_grad():
        got = port(_t(x))
    assert calls == [(2, 960, 24)]
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_block_in_bf16_is_within_the_jax_tolerance_of_the_unfused(calls):
    """The fused form adds the f32 residual before its one rounding; the
    unfused rounds the residual first (the JAX test's 3e-2)."""
    blk = tfs.DownsampleBlock(24, 48, 1, use_weight_norm=False,
                              generator=torch.Generator().manual_seed(0))
    blk = blk.to(torch.bfloat16).eval()
    x = _t(np.random.default_rng(4).standard_normal((2, 960, 24)),
           torch.bfloat16)
    with torch.no_grad():
        off = blk(x)
        dc.set_down_chain_mode("1")
        try:
            on = blk(x)
        finally:
            dc.set_down_chain_mode("0")
    assert len(calls) == 1 and on.dtype == torch.bfloat16
    np.testing.assert_allclose(on.float().numpy(), off.float().numpy(),
                               rtol=3e-2, atol=3e-2)


def test_generator_with_the_chain_equals_the_generator_without(calls):
    g = torch.Generator().manual_seed(0)
    model = tfs.FastSVCGenerator(in_channels=8, mid_channels=(16, 8),
                                 upsampling_scales=(4, 5), spk_emb_size=12,
                                 generator=g).eval().fold_weight_norm_()
    r = np.random.default_rng(1)
    ins = [torch.from_numpy(r.standard_normal(s).astype(np.float32))
           for s in ((2, 10, 8), (2, 200, 1), (2, 200, 1), (2, 12))]
    with torch.inference_mode():
        off = model(*ins, fuse_film=True)
        dc.set_down_chain_mode("1")
        try:
            on = model(*ins, fuse_film=True)
        finally:
            dc.set_down_chain_mode("0")
    # two blocks in each of the two chains; in f32 the two forms are equal
    assert len(calls) == 4
    assert torch.equal(on, off)


def test_grad_enabled_takes_the_unfused_path(chain_on, calls):
    blk = tfs.DownsampleBlock(8, 16, 2,
                              generator=torch.Generator().manual_seed(0))
    x = torch.randn((2, 128, 8), generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    y = blk(x)
    y.sum().backward()
    assert calls == [] and x.grad is not None
    with torch.no_grad():
        blk(x)
    assert calls == [(2, 64, 8)]


@pytest.mark.parametrize("T", [100, 20, 5])
def test_lengths_the_jax_kernel_refuses_equal_the_unfused_block(chain_on,
                                                                calls, T):
    """T % 32 != 0, T < 2 x the JAX halo (96), T below the reach (7)."""
    blk = tfs.DownsampleBlock(8, 16, 1, use_weight_norm=False,
                              generator=torch.Generator().manual_seed(T))
    blk.eval()
    x = _t(np.random.default_rng(T).standard_normal((2, T, 8)))
    with torch.no_grad():
        on = blk(x)
        dc.set_down_chain_mode("0")
        off = blk(x)
    assert calls == [(2, T, 8)]
    assert torch.equal(on, off)


def test_wrapper_and_mode_reject_what_they_do_not_take():
    blk = tfs.DownsampleBlock(8, 16, 1, use_weight_norm=False)
    params = blk.block_params()
    x = torch.zeros((2, 64, 8))
    with torch.no_grad():
        with pytest.raises(ValueError):  # not (B, T, Cin)
            dc.down_chain_fwd(x[0], params)
        with pytest.raises(ValueError):  # Cin does not fit conv1
            dc.down_chain_fwd(x[..., :4], params)
        with pytest.raises(ValueError):  # two dilations
            dc.down_chain_fwd(x, params, dilations=(1, 2))
        with pytest.raises(ValueError):  # a dilation below 1
            dc.down_chain_fwd(x, params, dilations=(1, 0, 4))
        with pytest.raises(ValueError):  # a conv without its bias
            dc.down_chain_fwd(x, dict(params, conv2={"w": params["conv2"]["w"],
                                                     "b": None}))
        with pytest.raises(ValueError):  # x and weights of two dtypes
            dc.down_chain_fwd(x.double(), params)
    with pytest.raises(ValueError):
        dc.set_down_chain_mode("auto")
    assert dc.down_chain_mode() == "0"
    assert dc.down_chain_takes(96, 192)
    assert not dc.down_chain_takes(193, 8)
    assert not dc.down_chain_takes(24, 48, (8, 16, 9))


def test_chain_offsets_match_jax():
    for dils in ((1, 2, 4), (1,), (4, 2, 1), (30, 3, 40)):
        assert dc.chain_offsets(dils) == jdc.chain_offsets(dils)
