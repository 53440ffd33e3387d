"""The port's chain of fixed gated blocks against the JAX package.

`ops/pd_block.py::pd_fixed_chain_plain` is held, on the CPU, to the JAX
package's Pallas chain kernel (`ops/pallas_pd_block.py::pd_fixed_chain`,
interpret mode off the TPU) at tests/test_pallas_pd_block.py's widths (R 16,
G 32, A 10, T 3200); `ResidualBlocks`' grouping of fixed blocks into chains
to the JAX `ResidualBlocks.apply` under the same FASTSVC_PD_CHAIN and
FASTSVC_PD_CHAIN_HALO (its kernel calls replaced by recorders); and a small
generator with chaining on to the JAX generator under
`set_pallas_pd_mode("1")`. The plan's routing: a run past the old kernel's
159-row reach stays one chain, a run longer than MAX_CHAIN goes block by
block, and widths the kernels refuse run plain (a generator at them held
to JAX's XLA path). Inputs are made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svcc23_fastsvc_tpu.models import hnusfgan as jhn
from svcc23_fastsvc_tpu.ops import pallas_pd_block as jpd
from svcc23_fastsvc_tpu_torch.compat import hnusfgan_state_dict_from_jax
from svcc23_fastsvc_tpu_torch.models import hnusfgan as thn
from svcc23_fastsvc_tpu_torch.ops import pd_block

R, G, A = 16, 32, 10
TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
# the recipe's vocoder layout: harmonic, noise and filter networks
RECIPE = [dict(blockA=20, cycleA=4, blockF=0, cycleF=0),
          dict(blockA=0, cycleA=0, blockF=5, cycleF=5),
          dict(blockA=0, cycleA=0, blockF=30, cycleF=3)]


def _t(a, dtype=torch.float32):
    """numpy or JAX array -> torch, through f32 (exact for bf16 values)."""
    return torch.from_numpy(np.asarray(a, np.float32).copy()).to(dtype)


def _chain_case(dils, T, dtype, seed):
    r = np.random.default_rng(seed)
    ps = []
    for i, d in enumerate(dils):
        blk = jhn.FixedBlock(residual_channels=R, gate_channels=G,
                             skip_channels=R, aux_channels=A, dilation=d,
                             use_weight_norm=False)
        ps.append(jax.tree.map(lambda v: v.astype(dtype),
                               blk.init(jax.random.PRNGKey(seed + i))))
    x = jnp.asarray(r.standard_normal((2, T, R)), jnp.float32).astype(dtype)
    c = jnp.asarray(r.standard_normal((2, T, A)), jnp.float32).astype(dtype)
    return ps, x, c


def _port(ps, dtype):
    return [jax.tree.map(lambda a: _t(a, dtype), p) for p in ps]


@pytest.mark.parametrize("dils,dtype", [
    ((1, 2, 4), jnp.float32),           # one filter cycle's prefix
    ((1, 2, 4, 8, 16), jnp.float32),    # the prefix the default halo takes
    ((1, 2, 4), jnp.bfloat16),
])
def test_chain_plain_matches_jax_chain_kernel(dils, dtype):
    ps, x, c = _chain_case(dils, 3200, dtype, seed=len(dils))
    want = np.asarray(jpd.pd_fixed_chain(x, c, ps, dilations=dils),
                      np.float32)
    tdt = TORCH[dtype]
    got = pd_block.pd_fixed_chain(_t(x, tdt), _t(c, tdt), _port(ps, tdt),
                                  dilations=dils)
    assert got.dtype == tdt and got.shape == x.shape
    tol = 2e-2 if dtype == jnp.bfloat16 else 2e-5
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_chain_takes_any_length_and_equals_the_blocks():
    """T % 32 != 0 (the JAX kernel's rule, which the card's does not need):
    the wrapper equals the blocks applied one after another."""
    dils = (1, 2, 4)
    ps, x, c = _chain_case(dils, 1007, jnp.float32, seed=7)
    params = _port(ps, torch.float32)
    x, c = _t(x), _t(c)
    want = x
    for p, d in zip(params, dils):
        want = pd_block.pd_fixed_block(want, c, p, dilation=d)
    got = pd_block.pd_fixed_chain(x, c, params, dilations=dils)
    assert torch.equal(got, want)


def test_chain_offsets_match_jax():
    for dils in ((1,), (1, 2, 4), (1, 2, 4, 8, 16), (1, 1, 1, 1, 1), (64, 3),
                 (33, 31, 2)):
        assert pd_block.fixed_chain_offsets(dils) == \
            jpd.fixed_chain_offsets(dils)


def test_chain_wrapper_raises_where_jax_does_and_on_bad_weights():
    dils = (1, 2, 4)
    ps, x, c = _chain_case(dils, 3200, jnp.float32, seed=1)
    params = _port(ps, torch.float32)
    x, c = _t(x), _t(c)
    with pytest.raises(ValueError, match=r"2 \* chain"):  # T < 2 x 96
        pd_block.pd_fixed_chain(x[:, :160], c[:, :160], params,
                                dilations=dils)
    with pytest.raises(ValueError):  # three dilations, two blocks
        pd_block.pd_fixed_chain(x, c, params[:2], dilations=dils)
    with pytest.raises(ValueError):  # a dilation below 1
        pd_block.pd_fixed_chain(x, c, params, dilations=(1, 0, 4))
    wide = [dict(p, conv={"w": torch.zeros(5, R, G), "b": torch.zeros(G)})
            for p in params]
    with pytest.raises(ValueError):  # not a K=3 conv
        pd_block.pd_fixed_chain(x, c, wide, dilations=dils)
    with pytest.raises(ValueError):  # c of the wrong width
        pd_block.pd_fixed_chain(x, c[..., :4], params, dilations=dils)


def _recorded_jax_plan(monkeypatch, nets, T, hop):
    """What JAX `ResidualBlocks.apply` launches, in order, with its block
    kernels replaced by recorders that return the stream unchanged."""
    calls = []

    def record(kind, key):
        def fn(*args, **kw):
            calls.append((kind, key(*args)))
            return args[1]
        return fn

    monkeypatch.setattr(jhn, "_fixed_chain_apply", record(
        "chain", lambda ps, x, c, dils: tuple(dils)))
    monkeypatch.setattr(jhn, "_fixed_fused_apply", record(
        "fixed", lambda p, x, c, dil: dil))
    monkeypatch.setattr(jhn, "_pd_fused_apply", record(
        "adaptive", lambda p, x, c, d, dil, hop: dil))
    monkeypatch.setattr(jhn.FixedBlock, "apply", lambda self, p, x, c: (
        calls.append(("fixed", self.dilation)), x)[1])
    x = jnp.zeros((1, T, 4), jnp.float32)
    c = jnp.zeros((1, T, 2), jnp.float32)
    d = jnp.ones((1, T), jnp.float32)
    jhn.set_pallas_pd_mode("1")
    try:
        for net in nets:
            rb = jhn.ResidualBlocks(**net, residual_channels=4,
                                    gate_channels=8, skip_channels=4,
                                    aux_channels=2, use_weight_norm=False,
                                    pd_frame_hop=hop)
            rb.apply(rb.init(jax.random.PRNGKey(0)), x, c, d)
    finally:
        jhn.set_pallas_pd_mode("auto")
    return calls


def _port_plan(nets, T, hop):
    out = []
    for net in nets:
        rb = thn.ResidualBlocks(**net, residual_channels=4, gate_channels=8,
                                skip_channels=4, aux_channels=2,
                                pd_frame_hop=hop)
        for kind, i in rb.plan(T):
            out.append((kind, tuple(rb.dilations[k] for k in i))
                       if kind == "chain" else (kind, rb.dilations[i]))
    return out


@pytest.mark.parametrize("chain,halo,T,nets", [
    ("5", None, 24000, RECIPE),
    ("3", None, 24000, RECIPE),
    ("5", "96", 24000, RECIPE),    # a smaller budget: (1, 2, 4) runs
    ("5", None, 288, RECIPE[1:]),  # T < 2 x 160: the noise run stops at 4
    ("5", None, 32, RECIPE[1:]),   # T < 2 x 32: no run at all
    ("5", None, 3201, RECIPE[1:]),  # T % 32 != 0: no run
    (None, None, 24000, RECIPE),   # chaining off by default
    ("0", None, 24000, RECIPE),
    ("1", None, 24000, RECIPE),
    ("five", None, 24000, RECIPE),
    ("10", "512", 24000, RECIPE),  # (1, .., 128): 255 rows of reach
])
def test_grouping_matches_jax(monkeypatch, chain, halo, T, nets):
    for name, value in (("FASTSVC_PD_CHAIN", chain),
                        ("FASTSVC_PD_CHAIN_HALO", halo)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    hop = 160 if T % 160 == 0 else 0
    want = _recorded_jax_plan(monkeypatch, nets, T, hop)
    got = _port_plan(nets, T, hop)
    assert got == want
    if chain in (None, "0", "1", "five") or T in (32, 3201):
        assert not any(kind == "chain" for kind, _ in got)


def _set_chain_env(monkeypatch, chain, halo):
    for name, value in (("FASTSVC_PD_CHAIN", chain),
                        ("FASTSVC_PD_CHAIN_HALO", halo)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)


def test_a_run_past_the_old_reach_is_one_chain_with_the_blocks_bits(
        monkeypatch):
    """FASTSVC_PD_CHAIN=10 and FASTSVC_PD_CHAIN_HALO=512 make the JAX
    grouping form a filter-cycle run (1, 2, .., 128), 255 rows of reach,
    past the 159 the card's chain kernel once held: the plan keeps it as one
    chain (the kernel now takes any reach), and the chain equals the blocks
    one after another."""
    _set_chain_env(monkeypatch, "10", "512")
    plan = _port_plan(RECIPE[2:], 24000, 160)
    assert plan[0] == ("chain", (1, 2, 4, 8, 16, 32, 64, 128))
    assert sum(plan[0][1]) == 255
    dils = (1, 2, 4, 8, 16, 32, 64, 128)
    ps, x, c = _chain_case(dils, 800, jnp.float32, seed=3)
    params = _port(ps, torch.float32)
    x, c = _t(x), _t(c)
    want = x
    for p, d in zip(params, dils):
        want = pd_block.pd_fixed_block(want, c, p, dilation=d)
    got = pd_block.pd_fixed_chain(x, c, params, dilations=dils)
    assert torch.equal(got, want)


def test_runs_longer_than_the_chain_kernel_go_block_by_block(monkeypatch):
    """With FASTSVC_PD_CHAIN=30 and a halo budget past every reach, JAX
    chains the filter net's 30 blocks in one run; the port's plan runs a
    run longer than MAX_CHAIN (16) as its blocks, in the same order (the
    same bits, pd_block.cuh's shared walks)."""
    _set_chain_env(monkeypatch, "30", "100000")
    want = _recorded_jax_plan(monkeypatch, RECIPE[2:], 24000, 160)
    dils = [2 ** (i % 10) for i in range(30)]
    assert want == [("chain", tuple(dils))]
    assert _port_plan(RECIPE[2:], 24000, 160) == [("fixed", d) for d in dils]


@pytest.mark.parametrize("R,G,A", [(64, 128, 96), (64, 160, 62)])
def test_widths_past_the_shared_walks_take_the_wide_walk_and_match_jax(
        monkeypatch, R, G, A):
    """3R + A = 288 > 272, or G = 160 > 128: the mma and ffma walks hold no
    such block, so the kernels' plan takes the wide walk in both dtypes and
    the vocoder's plan chains and launches as at any width; the port's
    generator at these widths matches the JAX one, which runs them on XLA
    off the TPU."""
    _set_chain_env(monkeypatch, "5", None)
    rb = thn.ResidualBlocks(0, 0, 5, 5, residual_channels=R, gate_channels=G,
                            aux_channels=A)
    assert rb.plan(24000) == [("chain", [0, 1, 2, 3, 4])]
    for dtype in (torch.float32, torch.bfloat16):
        assert pd_block.block_plan(dtype, 8, 24000, R, A, G)["variant"] \
            == "wide"
        assert pd_block.chain_plan(dtype, 8, 24000, R, A, G,
                                   (1,) * 5)["variant"] == "wide"
    nets = dict(
        harmonic_params=dict(blockA=2, cycleA=2, blockF=0, cycleF=0,
                             cascade_mode=0),
        noise_params=dict(blockA=0, cycleA=0, blockF=2, cycleF=2,
                          cascade_mode=0),
        filter_params=dict(blockA=0, cycleA=0, blockF=2, cycleF=1,
                           cascade_mode=0))
    widths = dict(residual_channels=R, gate_channels=G, skip_channels=R,
                  aux_channels=A, upsample_scales=(4, 5), pd_frame_hop=20,
                  use_weight_norm=False)
    jmodel = jhn.HNUSFGANGenerator(**nets, **widths)
    params = jmodel.init(jax.random.PRNGKey(2))
    r = np.random.default_rng(5)
    B, Tf, hop = 2, 16, 20
    x = (0.1 * r.standard_normal((B, Tf * hop, 2))).astype(np.float32)
    c = r.standard_normal((B, Tf + 4, A)).astype(np.float32)
    d = np.repeat(r.uniform(3.0, 12.0, (B, Tf)), hop, axis=1).astype(
        np.float32)
    y_jax, _ = jax.jit(jmodel.apply)(params, x, c, d)
    port = thn.HNUSFGANGenerator(**nets, **widths)
    port.load_state_dict(hnusfgan_state_dict_from_jax(
        jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        y, _ = port(*(torch.from_numpy(a) for a in (x, c, d)))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("chain,n_chains,n_fixed", [("5", 4, 15),
                                                    ("3", 5, 21)])
def test_recipe_launch_counts(monkeypatch, chain, n_chains, n_fixed):
    monkeypatch.setenv("FASTSVC_PD_CHAIN", chain)
    monkeypatch.delenv("FASTSVC_PD_CHAIN_HALO", raising=False)
    kinds = [kind for kind, _ in _port_plan(RECIPE, 24000, 160)]
    assert (kinds.count("adaptive"), kinds.count("chain"),
            kinds.count("fixed")) == (20, n_chains, n_fixed)


@pytest.mark.parametrize("chain,halo", [
    (None, None), ("0", "160"), ("1", "96"), ("2", "x"), ("5", "224"),
    ("7", None), ("x", "64"), ("-3", "0"),
])
def test_switches_read_as_jax_reads_them(monkeypatch, chain, halo):
    for name, value in (("FASTSVC_PD_CHAIN", chain),
                        ("FASTSVC_PD_CHAIN_HALO", halo)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    jhn.set_pallas_pd_mode("1")
    try:
        assert thn.chain_max() == jhn._chain_max(jnp.float32)
    finally:
        jhn.set_pallas_pd_mode("auto")
    assert thn.chain_halo_max() == jhn._chain_halo_max()


def test_generator_with_chains_matches_jax(monkeypatch):
    """FASTSVC_PD_CHAIN=5 on tests/test_pallas_pd_block.py's small
    generator: the noise net's five blocks and the filter net's (1, 2, 1,
    2, 1) run as chains in both packages (JAX: Pallas in interpret mode)."""
    monkeypatch.setenv("FASTSVC_PD_CHAIN", "5")
    monkeypatch.delenv("FASTSVC_PD_CHAIN_HALO", raising=False)
    nets = dict(
        harmonic_params=dict(blockA=2, cycleA=2, blockF=0, cycleF=0,
                             cascade_mode=0),
        noise_params=dict(blockA=0, cycleA=0, blockF=5, cycleF=5,
                          cascade_mode=0),
        filter_params=dict(blockA=0, cycleA=0, blockF=6, cycleF=3,
                           cascade_mode=0))
    widths = dict(residual_channels=R, gate_channels=G, skip_channels=R,
                  aux_channels=A, upsample_scales=(4, 5), pd_frame_hop=20,
                  use_weight_norm=False)
    jmodel = jhn.HNUSFGANGenerator(**nets, **widths)
    params = jmodel.init(jax.random.PRNGKey(1))
    r = np.random.default_rng(4)
    B, Tf, hop = 2, 160, 20
    x = r.standard_normal((B, Tf * hop, 2)).astype(np.float32)
    c = r.standard_normal((B, Tf + 4, A)).astype(np.float32)
    d = np.repeat(r.uniform(3.0, 12.0, (B, Tf)), hop, axis=1).astype(
        np.float32)
    jhn.set_pallas_pd_mode("1")
    try:
        y_jax, s_jax = jax.jit(jmodel.apply)(params, x, c, d)
    finally:
        jhn.set_pallas_pd_mode("auto")
    port = thn.HNUSFGANGenerator(**nets, **widths)
    port.load_state_dict(hnusfgan_state_dict_from_jax(
        jax.tree.map(np.asarray, params)))
    calls = []
    chain = thn.pd_fixed_chain

    def spy(x, c, params_list, *, dilations):
        calls.append(tuple(dilations))
        return chain(x, c, params_list, dilations=dilations)

    monkeypatch.setattr(thn, "pd_fixed_chain", spy)
    with torch.no_grad():
        y, s = port(*(torch.from_numpy(a) for a in (x, c, d)))
    assert calls == [(1, 1, 1, 1, 1), (1, 2, 1, 2, 1)]
    for got, want in ((y, y_jax), (s, s_jax)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-5)
