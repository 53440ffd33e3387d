"""The window-conv kernels' plans (`ops/window_conv.py::fwd_plan`,
`wgrad_plan`), on the CPU.

The plans choose each kernel's variant, tile, channel slabs and slots from
dtype and shapes alone, and the C entries refuse a plan that matches no
compiled instance. These tests hold the plans to their rules: every row
tile of a wgrad lands in exactly one slot, the slot scratch stays under its
cap at every shape chip_smoke.py times, the variant of each of the recipe
generator's decode and training convs follows the dtype-and-width rule,
and the tiles the plans name are the ones the CUDA sources compile. No
kernel runs here.
"""

import ast
import os
import re

import pytest
import torch

from svcc23_fastsvc_tpu_torch.config import build_generator
from svcc23_fastsvc_tpu_torch.ops import conv as conv_mod
from svcc23_fastsvc_tpu_torch.ops import window_conv as wc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "svcc23_fastsvc_tpu_torch", "csrc")
DTYPES = (torch.float32, torch.bfloat16)
# conf/fastsvc.yaml's generator, as chip_smoke.py builds it
GEN_CONFIG = {"generator_params": {
    "in_channels": 144, "out_channels": 1, "mid_channels": [192, 96, 48, 24],
    "upsampling_scales": [2, 4, 4, 5], "spk_emb_size": 512,
    "use_spk_emb": True}}


def _chip_smoke_shapes():
    """chip_smoke.py's shape lists, read from its source (importing it
    would start its watchdog)."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    wanted = {"B", "TB", "CONV_SHAPES", "GRAD_SHAPES", "FUSED_SHAPES"}
    ns = {}
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        names = {n.id for t in node.targets for n in ast.walk(t)
                 if isinstance(n, ast.Name)}
        if names & wanted:
            exec(compile(ast.Module([node], []), "chip_smoke.py", "exec"), ns)
    return ns


SHAPES = _chip_smoke_shapes()
# (B, T, Cin, Cout, dilation) of every wgrad chip_smoke.py runs, K = 3
GRAD_CASES = (
    [(SHAPES["TB"], T, ci, co, d) for _, T, ci, co, d, _ in
     SHAPES["GRAD_SHAPES"]]
    + [(nb, T, ci, co, d) for _, nb, T, ci, co, d, _ in
       SHAPES["FUSED_SHAPES"]])
EDGE_CASES = [(1, 1, 1, 1, 1), (3, 7, 24, 24, 27), (2, 300, 40, 48, 9),
              (1, 61, 24, 70, 27), (5, 16001, 384, 384, 1)]


def _generator_convs():
    """(T, Cin, Cout, K, dilation) of each window conv the recipe's
    generator runs on 2 frames: decode (no grad, fused FiLM) and a training
    forward (grad)."""
    seen = {"decode": [], "train": []}
    real = wc.window_conv
    path = ["decode"]

    def record(x, weight, bias=None, dilation=1, slope=None):
        seen[path[0]].append((x.shape[1], x.shape[2], weight.shape[2],
                              weight.shape[0], dilation))
        return real(x, weight, bias, dilation, slope)

    gen = build_generator(GEN_CONFIG, generator=torch.Generator().manual_seed(0))
    gen.fold_weight_norm_()
    tf, hop = 2, 160
    r = torch.Generator().manual_seed(1)
    ins = (torch.randn((1, tf, 144), generator=r),
           torch.randn((1, tf * hop, 1), generator=r),
           torch.randn((1, tf * hop, 1), generator=r),
           torch.randn((1, 512), generator=r))
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(wc, "window_conv", record)
        mp.setattr(conv_mod, "window_conv", record)
        with torch.no_grad():
            gen(*ins, fuse_film=True)
        path[0] = "train"
        gen(*ins).sum().backward()
    finally:
        mp.undo()
    return seen


GEN_CONVS = _generator_convs()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B,T,cin,cout,dil", GRAD_CASES + EDGE_CASES)
def test_every_row_tile_lands_in_exactly_one_slot(dtype, B, T, cin, cout,
                                                   dil):
    plan = wc.wgrad_plan(dtype, B, T, 3, cin, cout)
    rows = plan["rows"]
    assert plan["units"] == B * -(-T // rows)
    owner = {}
    for s in range(plan["n_slots"]):
        units = wc.slot_units(plan, s)
        assert len(units) >= 1, f"slot {s} is empty"
        for u in units:
            assert u not in owner, f"unit {u} in slots {owner[u]} and {s}"
            owner[u] = s
    assert sorted(owner) == list(range(plan["units"]))
    # a unit is up to `rows` rows of one utterance; together they are all
    # B*T rows
    n_tt = -(-T // rows)
    assert sum(min(rows, T - (u % n_tt) * rows) for u in owner) == B * T


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B,T,cin,cout,dil", GRAD_CASES + EDGE_CASES)
@pytest.mark.parametrize("K", [3, 5])
def test_wgrad_scratch_stays_under_its_cap(dtype, B, T, cin, cout, dil, K):
    plan = wc.wgrad_plan(dtype, B, T, K, cin, cout)
    words = plan["n_slots"] * (K * cin * cout + cout)
    assert words <= wc._WGRAD_MAX_WORDS
    assert 1 <= plan["n_slots"] <= max(1, plan["units"])
    # the slabs tile the channels
    assert plan["n_islabs"] == -(-cin // plan["ics"])
    if plan["variant"] != "stream":
        assert plan["n_oslabs"] == -(-cout // plan["tile_n"])


def _want_fwd(dtype, cin):
    return ("mma" if dtype == torch.bfloat16 and cin % 8 == 0 and cin >= 16
            else "ffma")


def _want_wgrad(dtype, cin, cout):
    if cin == 1:
        return "stream"
    if dtype == torch.bfloat16 and cin % 8 == 0 and cin >= 16 \
            and cout % 8 == 0:
        return "mma"
    return "ffma"


@pytest.mark.parametrize("path", ["decode", "train"])
def test_generator_convs_take_the_variant_the_rule_gives(path):
    convs = GEN_CONVS[path]
    assert len(convs) == (60 if path == "decode" else 72)
    # at the recipe's batch: decode 8 x 400 frames, training 32 x 100
    B, scale = (8, 200) if path == "decode" else (32, 50)
    for t, cin, cout, K, dil in convs:
        T = t * scale
        for dtype in DTYPES:
            assert wc.fwd_plan(dtype, B, T, cin, cout)["variant"] == \
                _want_fwd(dtype, cin)
            if path == "train":
                assert wc.fwd_plan(dtype, B, T, cout, cin)["variant"] == \
                    _want_fwd(dtype, cout)  # dx
                assert wc.wgrad_plan(dtype, B, T, K, cin, cout)[
                    "variant"] == _want_wgrad(dtype, cin, cout)
    # in bf16 every conv but the 1-channel ones runs on the tensor cores
    bf16 = [wc.fwd_plan(torch.bfloat16, B, t * scale, ci, co)["variant"]
            for t, ci, co, _, _ in convs]
    assert bf16.count("mma") == sum(ci != 1 for _, ci, _, _, _ in convs)
    assert bf16.count("mma") > 0


def test_plans_are_functions_of_the_shapes_alone():
    for B, T, cin, cout, dil in GRAD_CASES + EDGE_CASES:
        for dtype in DTYPES:
            a = wc.fwd_plan(dtype, B, T, cin, cout)
            assert a == wc.fwd_plan(dtype, B, T, cin, cout)
            p = wc.wgrad_plan(dtype, B, T, 3, cin, cout)
            assert p == wc.wgrad_plan(dtype, B, T, 3, cin, cout)
            assert all(isinstance(v, (int, str)) for v in (*a.values(),
                                                          *p.values()))
    # dilation is not an argument: the plan cannot depend on it


@pytest.mark.parametrize("B,T,cin,cout", [(4, 400, 86, 43), (8, 400, 144, 192),
                                          (8, 64000, 24, 24), (32, 100, 5, 24),
                                          (1, 1, 1, 1), (32, 16000, 1, 24)])
def test_ffma_rows_shrink_only_where_the_grid_leaves_most_sms_idle(B, T, cin,
                                                               cout):
    p = wc.fwd_plan(torch.float32, B, T, cin, cout)
    tn = 32 if cout <= 32 else 64
    tall = max(tm for tm, n in wc._FWD_FFMA_TILES if n == tn)
    blocks = B * -(-T // tall) * -(-cout // tn)
    assert p["variant"] == "ffma" and p["tn"] == tn
    assert p["tm"] == (tall if 2 * blocks >= wc._SMS else tall // 2)


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def test_forward_tiles_are_the_ones_the_source_compiles():
    src = _source("window_conv.cuh")
    body = src[src.index("int dispatch_window_conv("):]
    mma, ffma = body.split("kVariantFfma)", 1)
    tiles = lambda s: {(int(a), int(b)) for a, b in
                       re.findall(r"tm == (\d+) && tn == (\d+)", s)}
    assert tiles(mma) == set(wc._FWD_MMA_TILES)
    assert tiles(ffma) == set(wc._FWD_FFMA_TILES)
    for dtype in DTYPES:
        for cin, cout in ((1, 24), (24, 24), (48, 48), (144, 192),
                          (384, 384), (86, 43), (24, 1)):
            p = wc.fwd_plan(dtype, 8, 800, cin, cout)
            pool = wc._FWD_MMA_TILES if p["variant"] == "mma" else \
                wc._FWD_FFMA_TILES
            assert (p["tm"], p["tn"]) in pool
    assert f"kMmaKC = {wc._MMA_KC};" in src  # the packed weight's chunk
    assert re.search(r"enum \{ kVariantMma = (\d+), kVariantFfma = (\d+) \}",
                     src).groups() == tuple(
        str(wc.FWD_VARIANTS[v]) for v in ("mma", "ffma"))


def test_wgrad_plans_are_ones_the_source_compiles():
    src = _source("window_conv_grad.cu")
    mma = {(int(a), int(b)) for a, b in
           re.findall(r"tile_n == (\d+) && ppw == (\d+)", src)}
    ids = re.search(r"enum \{ kWgMma = (\d+), kWgFfma = (\d+), "
                    r"kWgStream = (\d+) \}", src).groups()
    assert ids == tuple(str(wc.WGRAD_VARIANTS[v])
                        for v in ("mma", "ffma", "stream"))
    assert f"kFfOcs = {wc._WGRAD_FFMA_OCS};" in src
    assert f"kStreamKMax = {wc._STREAM_MAX_K};" in src
    for B, T, cin, cout, dil in GRAD_CASES + EDGE_CASES:
        for K in (3, 5, 7):
            for dtype in DTYPES:
                p = wc.wgrad_plan(dtype, B, T, K, cin, cout)
                if p["variant"] == "mma":
                    assert (p["tile_n"], p["ppw"]) in mma
                    assert K * p["ics"] // 16 <= 8 * p["ppw"]
                    assert p["rows"] % 16 == 0 and p["ics"] % 16 == 0
                elif p["variant"] == "ffma":
                    assert K * (p["ics"] // 4) * (p["tile_n"] // 8) <= 256
                else:
                    assert cin == 1 and K <= wc._STREAM_MAX_K
                    assert p["tile_n"] in (1, 16 // torch.empty(
                        (), dtype=dtype).element_size())
