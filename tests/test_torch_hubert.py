"""The port's HuBERT-soft against the JAX package on the CPU.

The JAX test's SMALL widths (d_model 96, 2 layers, 4 heads, FFN 192,
conv 64, 32 units) on 0.5 s of 16 kHz audio from a numpy seed. Weights go
both ways: JAX `init` params (every leaf given noise from a numpy seed)
carried into the port by `hubert_state_dict_from_jax`, and a
bshall-layout checkpoint ({"hubert": state dict} with the training-only
keys such a file holds) read by the port's `load_hubert_soft` (at
bshall's 12 heads) and by JAX's converter, and through `hubert_state_dict`
in every positional-conv key form that converter takes.
Units agree to 1e-4 of their largest value (f32).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svcc23_fastsvc_tpu.models import hubert as jh
from svcc23_fastsvc_tpu_torch.compat import hubert_state_dict_from_jax
from svcc23_fastsvc_tpu_torch.models import hubert as th

SMALL = dict(d_model=96, n_layers=2, n_heads=4, ff_dim=192, conv_dim=64,
             unit_dim=32)
LOADED = {**SMALL, "n_heads": 12}  # the loader's head count
TOL = 1e-4


def wav(seed=1, n=8000):
    r = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    return (0.3 * np.sin(2 * np.pi * 180 * t * (1 + 0.1 * t))
            + 0.05 * r.standard_normal(n)).astype(np.float32)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def jax_units(params, x, hop10ms=True, widths=SMALL):
    model = jh.HubertSoft(hop10ms=hop10ms, **widths)
    return np.asarray(jax.jit(model.apply)(params, jnp.asarray(x)))


def port_units(model, x):
    with torch.no_grad():
        return model.eval()(torch.from_numpy(x)).numpy()


def noisy_jax_params(hop10ms, seed=2):
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * r.standard_normal(a.shape)
                   ).astype(np.float32),
        jh.HubertSoft(hop10ms=hop10ms, **SMALL).init(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("hop10ms", [True, False])
def test_forward_matches_jax(hop10ms):
    params = noisy_jax_params(hop10ms)
    x = wav()
    want = jax_units(params, x, hop10ms)
    model = th.HubertSoft(hop10ms=hop10ms, **SMALL)
    model.load_state_dict(hubert_state_dict_from_jax(params))
    got = port_units(model, x)
    # 10 ms hop: ~100 frames a second; 20 ms: ~50
    assert got.shape == (1, 49 if hop10ms else 25, 32)
    _close(got, want)


def test_state_dict_from_jax_inverts_the_jax_converter():
    params = noisy_jax_params(True)
    back = jh.convert_hubert_state_dict(hubert_state_dict_from_jax(params),
                                        jh.HubertSoft(**SMALL))
    flat_p, tree_p = jax.tree_util.tree_flatten(params)
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_p == tree_b
    for a, b in zip(flat_p, flat_b):
        np.testing.assert_allclose(np.asarray(b), a, rtol=2e-6, atol=1e-7)


def _bshall_file(tmp_path, seed=3, widths=SMALL):
    torch.manual_seed(seed)
    model = th.HubertSoft(**widths)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape))
    ckpt = th.bshall_checkpoint(model, seed=seed)
    path = str(tmp_path / "hubert-soft.pt")
    torch.save(ckpt, path)
    return path, ckpt


def test_bshall_checkpoint_through_both_loaders(tmp_path):
    """`load_hubert_soft` takes its widths from the file and bshall's 12
    heads (d_model 96 splits into 12 heads of 8)."""
    path, ckpt = _bshall_file(tmp_path, widths=LOADED)
    assert {"masked_spec_embed", "label_embedding.weight"} <= set(
        ckpt["hubert"])
    model = th.load_hubert_soft(path, device="cpu")
    assert not model.training
    assert model.encoder.layers[0].self_attn.n_heads == 12
    # the JAX loader: torch.load, the "hubert" key, convert_hubert_state_dict
    sd = torch.load(path, map_location="cpu")
    params = jh.convert_hubert_state_dict(sd["hubert"],
                                          jh.HubertSoft(**LOADED))
    x = wav(4)
    _close(port_units(model, x), jax_units(params, x, widths=LOADED))


@pytest.mark.parametrize("form", ["weight_norm", "folded", "fairseq",
                                  "pos_conv_embed"])
def test_positional_conv_key_forms_match_jax(tmp_path, form):
    """Each positional-conv key form JAX's converter takes gives the same
    units in the port (through `hubert_state_dict`) and in JAX."""
    _, ckpt = _bshall_file(tmp_path, seed=5)
    sd = dict(ckpt["hubert"])
    g = sd.pop("positional_embedding.conv.weight_g")
    v = sd.pop("positional_embedding.conv.weight_v")
    b = sd.pop("positional_embedding.conv.bias")
    if form == "weight_norm":
        sd.update({"positional_embedding.conv.weight_g": g,
                   "positional_embedding.conv.weight_v": v,
                   "positional_embedding.conv.bias": b})
    elif form == "folded":
        w = g * v / torch.linalg.vector_norm(v, dim=(0, 1), keepdim=True)
        sd.update({"positional_embedding.conv.weight": w,
                   "positional_embedding.conv.bias": b})
    elif form == "fairseq":
        sd.update({"encoder.pos_conv.0.weight_g": g,
                   "encoder.pos_conv.0.weight_v": v,
                   "encoder.pos_conv.0.bias": b})
    else:  # norm over dims (1, 2), as JAX folds this form
        g0 = torch.rand(v.shape[0], 1, 1) + 0.5
        sd.update({"encoder.pos_conv_embed.conv.weight_g": g0,
                   "encoder.pos_conv_embed.conv.weight_v": v,
                   "encoder.pos_conv_embed.conv.bias": b})
    model = th.HubertSoft(**SMALL)
    model.load_state_dict(th.hubert_state_dict(sd))
    params = jh.convert_hubert_state_dict(sd, jh.HubertSoft(**SMALL))
    x = wav(6)
    _close(port_units(model, x), jax_units(params, x))


def test_module_prefix_is_not_stripped_as_in_jax(tmp_path):
    """Kept from the JAX converter: keys under a leading "module." (as a
    DDP-saved file holds them) are not found."""
    _, ckpt = _bshall_file(tmp_path, seed=7)
    sd = {f"module.{k}": v for k, v in ckpt["hubert"].items()}
    with pytest.raises(KeyError):
        th.hubert_state_dict({"hubert": sd})
    with pytest.raises(KeyError):
        jh.convert_hubert_state_dict(sd, jh.HubertSoft(**SMALL))


def test_one_utterance_a_call():
    """norm0 normalises over the whole time axis: the units of an
    utterance padded with zeros differ from its own."""
    torch.manual_seed(8)
    model = th.HubertSoft(**SMALL).eval()
    x = torch.from_numpy(wav(9))
    padded = torch.cat([x, torch.zeros(3200)])
    with torch.no_grad():
        alone = model(x)
        batched = model(padded[None])[:, :alone.shape[1]]
    assert not torch.allclose(alone, batched, atol=1e-3)


def test_loader_refuses_cuda_without_a_gpu(tmp_path, monkeypatch):
    path, _ = _bshall_file(tmp_path, seed=10)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        th.load_hubert_soft(path)
