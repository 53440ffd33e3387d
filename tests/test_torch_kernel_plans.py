"""The fused-conv backward's, the vocoder blocks', the chain's and the down
chain's plans (`ops/fused_conv.py::bwd_plan`, `ops/pd_block.py::
block_plan` / `chain_plan`, `ops/down_chain.py::down_plan`) and the model
loaders' default device, on the CPU.

The plans choose each kernel's variant, row tile, channel slabs, stages
and slots from dtype and shapes alone, and the C entries refuse a plan that
matches no compiled instance. These tests hold the plans to their rules:
every row tile of a backward lands in exactly one slot, the slot scratch
and the shared memory stay under their caps, the slots fill an H100 at the
shapes chip_smoke.py times, the generator's training convs and the
vocoder's blocks take the variant the dtype-and-width rule gives, and the
instances the plans name are the ones the CUDA sources compile (read with
regexes). No kernel runs here.
"""

import ast
import ctypes
import os
import re
import shutil
import subprocess

import pytest
import torch

from svcc23_fastsvc_tpu_torch.config import build_acoustic_model, build_vocoder
from svcc23_fastsvc_tpu_torch.ops import down_chain as dc
from svcc23_fastsvc_tpu_torch.ops import fused_conv as fc
from svcc23_fastsvc_tpu_torch.ops import pd_block as pb
from svcc23_fastsvc_tpu_torch.train import checkpoint as ckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "svcc23_fastsvc_tpu_torch", "csrc")
DTYPES = (torch.float32, torch.bfloat16)


def _chip_smoke_names(wanted):
    """chip_smoke.py's module-level constants, read from its source
    (importing it would start its watchdog)."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    ns = {}
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        names = {n.id for t in node.targets for n in ast.walk(t)
                 if isinstance(n, ast.Name)}
        if names & wanted:
            exec(compile(ast.Module([node], []), "chip_smoke.py", "exec"), ns)
    return ns


SMOKE = _chip_smoke_names({"B", "TB", "FUSED_SHAPES", "VB", "VTF", "VHOP",
                           "DOWN_SHAPES"})
# (B, T, Cin, Cout) of every #6 call chip_smoke.py times, K = 3
FUSED_CASES = [(nb, T, ci, co) for _, nb, T, ci, co, _, _ in
               SMOKE["FUSED_SHAPES"]]
# (T, Cin, Cout, need_dx) of the 53 fused-conv backward calls of one
# generator training step under FASTSVC_PALLAS_CONV=1 at 16000 samples
# (the recipe's generator; K = 3; counts in brackets)
TRAIN_CONVS = (
    [(800, 48, 96)] * 2 + [(800, 96, 48)] + [(800, 96, 96)] * 15
    + [(3200, 24, 48)] * 2 + [(3200, 48, 24)] + [(3200, 48, 48)] * 15
    + [(16000, 1, 24)] * 2 + [(16000, 24, 24)] * 15)
EDGE_CASES = [(1, 256, 1, 1), (2, 257, 12, 20), (1, 300, 8, 8),
              (4, 402, 21, 3), (2, 320, 192, 192), (3, 1000, 16, 8),
              (1, 100000, 24, 24), (64, 16000, 96, 96)]
SMS = 132


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _constant(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B,T,cin,cout", FUSED_CASES + EDGE_CASES)
@pytest.mark.parametrize("K", [2, 3, 5])
def test_every_row_tile_lands_in_exactly_one_slot(dtype, B, T, cin, cout, K):
    plan = fc.bwd_plan(dtype, B, T, K, cin, cout)
    rows = plan["rows"]
    assert plan["tiles"] == B * -(-T // rows)
    owner = {}
    for s in range(plan["n_slots"]):
        tiles = fc.slot_tiles(plan, s)
        assert len(tiles) >= 1, f"slot {s} is empty"
        for u in tiles:
            assert u not in owner, f"tile {u} in slots {owner[u]} and {s}"
            owner[u] = s
    assert sorted(owner) == list(range(plan["tiles"]))
    # a tile is up to `rows` rows of one utterance; together all B*T rows
    n_tt = -(-T // rows)
    assert sum(min(rows, T - (u % n_tt) * rows) for u in owner) == B * T


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B,T,cin,cout", FUSED_CASES + EDGE_CASES)
@pytest.mark.parametrize("K", [2, 3, 5])
def test_backward_scratch_and_shared_memory_stay_under_their_caps(
        dtype, B, T, cin, cout, K):
    p = fc.bwd_plan(dtype, B, T, K, cin, cout)
    assert p["n_slots"] * (K * cin * cout + cout) <= fc._MAX_SLOT_WORDS
    assert 1 <= p["n_slots"] <= p["tiles"]
    assert p["n_islabs"] == -(-cin // p["isl"])
    # at the largest reach the kernel takes, whatever the dilation
    assert fc.bwd_smem_bytes(p["variant"], p["rows"], p["isl"], K, cout,
                             p["stages"]) <= fc._SMEM_BYTES


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B,T,cin,cout", FUSED_CASES)
def test_backward_slots_fill_the_card(dtype, B, T, cin, cout):
    """One block per slot and slab: at chip_smoke's shapes (the narrow
    (8, 400, 144) -> 192 among them) the grid covers the H100's SMs, or
    takes every tile there is."""
    p = fc.bwd_plan(dtype, B, T, 3, cin, cout)
    per_sm = fc._BWD_BLOCKS_PER_SM[p["variant"]]
    assert p["n_slots"] * p["n_islabs"] >= min(
        per_sm * SMS, p["tiles"] * p["n_islabs"])


def _want_bwd(dtype, cin, cout):
    if cin == 1 and cout <= 64:
        return "stream"
    if dtype == torch.bfloat16 and cin % 8 == 0 and cin >= 16 \
            and cout % 8 == 0 and cout <= 192:
        return "mma"
    return "ffma"


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_training_convs_take_the_variant_the_rule_gives(dtype):
    assert len(TRAIN_CONVS) == 53
    for T, cin, cout in TRAIN_CONVS:
        p = fc.bwd_plan(dtype, 32, T, 3, cin, cout)
        assert p["variant"] == _want_bwd(dtype, cin, cout)
        # one slab: every training conv reads its x and g windows once
        assert p["n_islabs"] == 1
        assert p["rows"] == (256 if p["isl"] <= fc._WIDE_SLAB else 64)
    # in bf16 every conv but the 1-channel ones runs on the tensor cores
    got = [fc.bwd_plan(dtype, 32, T, 3, ci, co)["variant"]
           for T, ci, co in TRAIN_CONVS]
    if dtype == torch.bfloat16:
        assert got.count("mma") == sum(ci != 1 for _, ci, _ in TRAIN_CONVS)


def test_plans_are_functions_of_the_shapes_alone():
    for B, T, cin, cout in FUSED_CASES + EDGE_CASES:
        for dtype in DTYPES:
            for K in (2, 3, 5):
                a = fc.bwd_plan(dtype, B, T, K, cin, cout)
                fc.bwd_plan.cache_clear()
                assert a == fc.bwd_plan(dtype, B, T, K, cin, cout)
                assert all(isinstance(v, (int, str)) for v in a.values())
    for B, T, R, A, G in BLOCK_CASES:
        for dtype in DTYPES:
            a = pb.block_plan(dtype, B, T, R, A, G)
            pb.block_plan.cache_clear()
            assert a == pb.block_plan(dtype, B, T, R, A, G)
            assert all(isinstance(v, (int, str)) for v in a.values())
    # dilation, hop and shifts are not arguments: the plans cannot depend
    # on them


def test_backward_instances_are_ones_the_source_compiles():
    src = _source("fused_conv.cu")
    ids = re.search(r"enum \{ kBwdMma = (\d+), kBwdFfma = (\d+), "
                    r"kBwdStream = (\d+) \}", src).groups()
    assert ids == tuple(str(fc.BWD_VARIANTS[v])
                        for v in ("mma", "ffma", "stream"))
    compiled = {(v.lower(), int(r)) for v, r in re.findall(
        r"variant == kBwd(\w+) && a\.rows == (\d+)", src)}
    assert compiled == {(v, r) for v, rows in fc.BWD_ROWS.items()
                        for r in rows}
    mma_pw = {int(tm): int(pw) for tm, _, pw in re.findall(
        r"launch_bwd_mma<(\d+), (\d+), (\d+)>", src)}
    assert mma_pw == fc._MMA_PAIRS_PER_WARP
    assert _constant(src, "kBwMmaMaxSlab") == fc._MMA_MAX_SLAB
    assert _constant(src, "kBwMaxOut") == fc._MMA_MAX_OUT
    assert _constant(src, "kBwFfMaxSlab") == fc._FFMA_MAX_SLAB
    assert _constant(src, "kStreamMaxOut") == fc._STREAM_MAX_OUT
    assert _constant(src, "kBwUnits") * 256 == fc._FFMA_UNITS
    assert _constant(src, "kBwDwTiles") == fc._MMA_DW_TILES
    for B, T, cin, cout in FUSED_CASES + EDGE_CASES:
        for dtype in DTYPES:
            for K in (2, 3, 5):
                p = fc.bwd_plan(dtype, B, T, K, cin, cout)
                assert (p["variant"], p["rows"]) in compiled
                if p["variant"] == "mma":
                    wp = 8 // fc._dw_groups(cout)
                    assert p["isl"] % 16 == 0 and p["isl"] <= 96
                    assert K * p["isl"] // 16 <= wp * mma_pw[p["rows"]]
                elif p["variant"] == "ffma":
                    assert p["isl"] % 8 == 0 and p["isl"] <= 128
                    assert K * (p["isl"] // 4) * -(-cout // 8) <= 1024
                    # every dx row has a thread: 4 rows a thread at most
                    assert 256 // (p["isl"] // 8) * 4 >= p["rows"]
                else:
                    assert cin == 1 and p["isl"] == 1 and p["stages"] == 2


# B, T, R, A, G: the vocoder's blocks (aux 62 and 63), the CUDA tests'
# narrow ones, the block classes' default aux 80, and widths the mma and
# ffma walks do not hold (3R + A = 288, G = 160, R = 96, all three)
BLOCK_CASES = [(8, 24000, 64, 62, 128), (4, 64000, 64, 63, 128),
               (2, 3200, 16, 10, 32), (1, 2000, 8, 10, 16),
               (2, 1007, 64, 80, 128), (1, 1, 1, 0, 2), (3, 999, 12, 7, 20),
               (8, 24000, 64, 96, 128), (2, 1000, 64, 62, 160),
               (1, 500, 96, 10, 64), (2, 333, 130, 300, 514)]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B,T,R,A,G", BLOCK_CASES)
def test_block_plan_takes_the_variant_the_rule_gives(dtype, B, T, R, A, G):
    p = pb.block_plan(dtype, B, T, R, A, G)
    held = R <= 64 and G <= 128 and 3 * R + A <= 272
    mma = held and dtype == torch.bfloat16 and R % 8 == 0 and \
        pb._mma_smem_bytes(R, A) <= pb._SMEM_BYTES
    assert p["variant"] == ("wide" if not held else "mma" if mma else "ffma")
    assert p["tiles"] == B * -(-T // p["tile_rows"])
    assert 1 <= p["n_blocks"] <= min(SMS, p["tiles"])
    if p["variant"] == "mma":
        assert pb._mma_smem_bytes(R, A) <= pb._SMEM_BYTES
    if p["variant"] == "ffma":
        assert _ffma_smem_bytes(R, A) <= pb._SMEM_BYTES
    # the wide walk's z scratch: 64 rows of G/2 for each block of threads
    assert p["z_elems"] == (p["n_blocks"] * 64 * (G // 2)
                            if p["variant"] == "wide" else 0)


def test_vocoder_blocks_run_on_the_tensor_cores_in_bf16():
    """Every gated block of the B02 vocoder at its widths (aux 62, and 63
    from the B02 acoustic features): mma in bf16, ffma in f32, a grid of
    one block per SM."""
    for A in (62, 63):
        for dtype, want in ((torch.bfloat16, "mma"), (torch.float32, "ffma")):
            p = pb.block_plan(dtype, 8, 24000, 64, A, 128)
            assert p["variant"] == want and p["n_blocks"] == SMS


def test_block_plans_refuse_widths_no_instance_takes():
    """Past R 64, G 128 or 3R + A 272 the wide walk takes a block (any
    widths, as the JAX kernels); an odd or empty gate, R < 1, A < 0 or a
    width past the C entries' 2^20 no instance takes."""
    for R, A, G in ((65, 10, 128), (64, 10, 130), (64, 81, 128)):
        assert pb.block_plan(torch.bfloat16, 1, 100, R, A, G)["variant"] \
            == "wide"
    for R, A, G in ((64, 10, 127), (0, 10, 128), (64, -1, 128), (64, 10, 0),
                    (2 ** 20 + 1, 10, 128), (64, 10, 2 ** 20 + 2)):
        with pytest.raises(ValueError):
            pb.block_plan(torch.bfloat16, 1, 100, R, A, G)


def test_block_instances_are_ones_the_source_compiles():
    src = _source("pd_block.cu")
    ids = re.search(r"enum \{ kPdMma = (\d+), kPdFfma = (\d+), "
                    r"kPdWide = (\d+) \}", _source("pd_block.cuh")).groups()
    assert ids == tuple(str(pb.BLOCK_VARIANTS[v])
                        for v in ("mma", "ffma", "wide"))
    compiled = {(v.lower(), int(r)) for v, r in re.findall(
        r"variant == kPd(\w+) && tile_rows == (\d+)", src)}
    assert compiled == set(pb._BLOCK_TILE_ROWS.items())
    for name, value in (("kMaxFeatures", pb.MAX_FEATURES),
                        ("kMaxR", pb.MAX_RESIDUAL),
                        ("kMaxHalf", pb.MAX_GATE // 2),
                        ("kWdRows", pb._BLOCK_TILE_ROWS["wide"])):
        assert _constant(_source("pd_block.cuh"), name) == value, name
    for B, T, R, A, G in BLOCK_CASES:
        for dtype in DTYPES:
            p = pb.block_plan(dtype, B, T, R, A, G)
            assert (p["variant"], p["tile_rows"]) in compiled


# the loaders' default device: cuda, raising without one

VOC_CFG = {
    "sampling_rate": 24000, "hop_size": 160, "aux_context_window": 2,
    "generator_params": {
        "harmonic_network_params": {"blockA": 1, "cycleA": 1, "blockF": 0,
                                    "cycleF": 0, "cascade_mode": 0},
        "noise_network_params": {"blockA": 0, "cycleA": 0, "blockF": 1,
                                 "cycleF": 1, "cascade_mode": 0},
        "filter_network_params": {"blockA": 0, "cycleA": 0, "blockF": 1,
                                  "cycleF": 1, "cascade_mode": 0},
        "residual_channels": 8, "gate_channels": 16, "skip_channels": 8,
        "aux_channels": 10, "aux_context_window": 2,
        "upsample_params": {"upsample_scales": [5, 4, 4, 2]}},
}
TACO_CFG = {"generator_params": dict(
    input_dim=16, output_dim=60, hidden_dim=32, dec_layers=2,
    multi_speaker=True, spk_emb_dim=8, integrate_logf0=True,
    econv_chans=16, prenet_dim=8)}


def _saved(tmp_path, model, name):
    path = str(tmp_path / name)
    ckpt.save_generator_checkpoint(path, model, 3)
    return path


@pytest.mark.parametrize("which", ["vocoder", "acoustic"])
def test_loaders_default_to_cuda_and_raise_without_a_gpu(tmp_path,
                                                         monkeypatch, which):
    g = torch.Generator().manual_seed(0)
    if which == "vocoder":
        cfg, load = VOC_CFG, ckpt.load_vocoder
        path = _saved(tmp_path, build_vocoder(cfg, generator=g), "v.pkl")
    else:
        cfg, load = TACO_CFG, ckpt.load_acoustic_model
        path = _saved(tmp_path, build_acoustic_model(cfg, generator=g),
                      "a.pkl")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        load(path, cfg)
    with pytest.raises(RuntimeError, match="CUDA device"):
        load(path, cfg, device="cuda")
    model, steps = load(path, cfg, device="cpu")
    assert steps == 3
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    assert all(torch.isfinite(p).all() for p in model.parameters())


def _struct_fields(src, name):
    """The field names of C struct `name` in `src`, in order."""
    body = re.search(rf"struct {name} \{{(.*?)\}};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        for piece in decl.split(","):
            if piece.strip():
                names.append(re.sub(r"\[.*\]", "", piece).split()[-1]
                             .lstrip("*"))
    return names


@pytest.mark.parametrize("struct,source,fields", [
    ("PdBlockWeights", "pd_block.cuh", pb._Weights),
    ("PdBlockArgs", "pd_block.cu", pb._Args),
    ("PdChainArgs", "pd_chain.cu", pb._ChainArgs),
    ("DownChainArgs", "down_chain.cu", dc._Args),
])
def test_block_argument_structures_match_the_sources(struct, source, fields):
    """The ctypes structures the wrappers fill name the C structs' fields in
    the same order (every field 8 bytes, so the order is the layout)."""
    assert _struct_fields(_source(source), struct) == \
        [f[0] for f in fields._fields_]
    assert all(ctypes.sizeof(t) % 8 == 0 for _, t in fields._fields_)


# the chain (#9): B, T, R, A, G, dilations. The vocoder's noise net and a
# filter cycle's prefix at chip_smoke's shape, reaches past the old 159-row
# limit, MAX_CHAIN blocks, runs of rows that cross utterances, the CUDA
# tests' narrow widths
CHAIN_PLAN_CASES = [
    (SMOKE["VB"], SMOKE["VTF"] * SMOKE["VHOP"], 64, 62, 128, (1,) * 5),
    (SMOKE["VB"], SMOKE["VTF"] * SMOKE["VHOP"], 64, 62, 128,
     (1, 2, 4, 8, 16)),
    (8, 24000, 64, 63, 128, (1, 2, 4, 8, 16, 32, 64, 128)),
    (2, 3072, 16, 10, 32, (1, 2, 4, 8, 16, 32, 64, 128, 256)),
    (2, 1056, 64, 63, 128, (1,) * 16),
    (40, 320, 64, 62, 128, (1, 2, 4, 8, 16)),
    (1, 1007, 16, 10, 32, (1, 2, 4)),
    (2, 960, 64, 62, 128, (2,)),
    (3, 999, 12, 7, 20, (1, 2)),
    (8, 24000, 64, 96, 128, (1, 2, 4, 8, 16)),
    (2, 4000, 64, 62, 160, (1,) * 5),
]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B,T,R,A,G,dils", CHAIN_PLAN_CASES)
def test_chain_plan_covers_every_row_within_its_caps(dtype, B, T, R, A, G,
                                                     dils):
    """The chain's grid covers every row once (runs of seg_rows, one block
    of threads an SM at most), its stages run the block kernels' variant
    and tile (so their shared memory is the blocks'), each block of
    threads' scratch regions hold its run and the halo on either side, and
    the scratch is the two regions of every block of threads."""
    p = pb.chain_plan(dtype, B, T, R, A, G, dils)
    bp = pb.block_plan(dtype, B, T, R, A, G)
    assert (p["variant"], p["tile_rows"]) == (bp["variant"], bp["tile_rows"])
    assert 1 <= p["n_blocks"] <= SMS
    assert p["n_blocks"] * p["seg_rows"] >= B * T
    assert (p["n_blocks"] - 1) * p["seg_rows"] < B * T
    assert p["region_rows"] == p["seg_rows"] + 2 * sum(dils)
    assert p["scratch_rows"] == (2 * p["n_blocks"] * p["region_rows"]
                                 if len(dils) > 1 else 0)
    assert p["z_elems"] == (p["n_blocks"] * 64 * (G // 2)
                            if p["variant"] == "wide" else 0)
    smem = (pb._mma_smem_bytes(R, A) if p["variant"] == "mma"
            else _ffma_smem_bytes(R, A) if p["variant"] == "ffma"
            else _WIDE_SMEM_BYTES)
    assert smem <= pb._SMEM_BYTES
    # at chip_smoke's shape every SM has a run of rows
    if (B, T) == (SMOKE["VB"], SMOKE["VTF"] * SMOKE["VHOP"]):
        assert p["n_blocks"] == SMS


def _ffma_smem_bytes(R, A):
    """ffma_smem_bytes in csrc/pd_block.cuh: two stages of 256 rows of 16
    features (+4), 128 z rows of 68, the f32 gate weight and Wo, the
    biases."""
    kw = (3 * R + A + 3) & ~3
    return (2 * 256 * 20 + 128 * 68 + 128 * kw + 64 * 64 + 128 + 64) * 4


# wide_smem_bytes in csrc/pd_block.cuh: a 64 x 33 f32 chunk of rows, a
# 32 x 64 one of weights, three taps' 64 source rows (8 bytes each)
_WIDE_SMEM_BYTES = (64 * 33 + 32 * 64) * 4 + 3 * 64 * 8


def test_chain_plans_are_functions_of_the_shapes_and_refuse_other_widths():
    for B, T, R, A, G, dils in CHAIN_PLAN_CASES:
        for dtype in DTYPES:
            a = pb.chain_plan(dtype, B, T, R, A, G, dils)
            pb.chain_plan.cache_clear()
            assert a == pb.chain_plan(dtype, B, T, R, A, G, dils)
            assert all(isinstance(v, (int, str)) for v in a.values())
    for R, A, G, dils in ((0, 10, 128, (1, 2)), (64, 62, 127, (1, 2)),
                          (64, -1, 128, (1, 2)), (64, 62, 128, (1,) * 17),
                          (64, 62, 128, ())):
        with pytest.raises(ValueError):
            pb.chain_plan(torch.bfloat16, 1, 1000, R, A, G, dils)


def test_chain_instances_are_ones_the_source_compiles():
    """The chain's dispatch names the block kernels' variants and tiles,
    and its limit is MAX_CHAIN."""
    src = _source("pd_chain.cu")
    compiled = {(v.lower(), int(r)) for v, r in re.findall(
        r"variant == kPd(\w+) && tile_rows == (\d+)", src)}
    assert compiled == set(pb._BLOCK_TILE_ROWS.items())
    assert _constant(src, "kMaxChain") == pb.MAX_CHAIN
    for B, T, R, A, G, dils in CHAIN_PLAN_CASES:
        for dtype in DTYPES:
            p = pb.chain_plan(dtype, B, T, R, A, G, dils)
            assert (p["variant"], p["tile_rows"]) in compiled


# the down chain (#7): B, T, Cin, C, dilations. chip_smoke's shapes, the
# CUDA tests' and the limits: 192 channels in and out, 32 rows of reach
DOWN_PLAN_CASES = (
    [(nb, T, cin, c, (1, 2, 4)) for _, nb, T, i in SMOKE["DOWN_SHAPES"]
     for cin, c in [((1, 24), (24, 48), (48, 96), (96, 192))[i]]]
    + [(2, 1600, 1, 24, (1, 2, 4)), (2, 20, 8, 16, (1, 2, 4)),
       (1, 5, 4, 24, (1, 2, 4)), (2, 300, 16, 40, (2, 3, 5)),
       (8, 800, 96, 192, (1, 2, 4)), (2, 257, 192, 192, (8, 8, 16)),
       (3, 130, 5, 12, (1, 2, 4)), (1, 4000, 192, 192, (1, 15, 16)),
       (1, 4000, 192, 1, (30, 1, 1)), (4, 100000, 1, 192, (1, 2, 4))])


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B,T,cin,c,dils", DOWN_PLAN_CASES)
def test_down_plan_stays_within_its_caps(dtype, B, T, cin, c, dils):
    """The variant is the dtype's; the tile's stage-1 rows fit the warps'
    m16 tiles (mma) or the threads' rows (ffma), its shared memory fits the
    card, and the grid covers the tiles with at most the blocks of threads
    the SMs hold at once."""
    p = dc.down_plan(dtype, B, T, cin, c, dils)
    variant = "mma" if dtype == torch.bfloat16 else "ffma"
    assert p["variant"] == variant
    S = p["tile_rows"]
    assert 1 <= S <= dc.max_tile(variant, cin, c, dils)
    rows1 = S + 2 * (dils[1] + dils[2])
    if variant == "mma":
        assert -(-rows1 // 16) <= dc._MAX_MT * dc._wm(c)
    else:
        assert rows1 <= dc._MAX_RPT * dc._ty(c)
    assert p["smem"] == dc.smem_bytes(variant, S, sum(dils), cin, c)
    assert p["smem"] <= dc._SMEM_BYTES
    per_sm = dc.blocks_per_sm(variant, c, p["smem"])
    assert per_sm * (p["smem"] + 1024) <= dc._SM_SMEM
    assert p["tiles"] == B * -(-T // S)
    assert 1 <= p["n_blocks"] <= min(p["tiles"], per_sm * SMS)


def test_down_plan_fills_the_card_at_the_decode_shapes():
    """At chip_smoke's decode shapes every SM gets a block of threads."""
    for _, nb, T, i in SMOKE["DOWN_SHAPES"]:
        cin, c = ((1, 24), (24, 48), (48, 96), (96, 192))[i]
        for dtype in DTYPES:
            p = dc.down_plan(dtype, nb, T, cin, c, (1, 2, 4))
            assert p["n_blocks"] >= min(p["tiles"], SMS)


def test_down_plans_are_functions_of_the_shapes_and_refuse_other_widths():
    for B, T, cin, c, dils in DOWN_PLAN_CASES:
        for dtype in DTYPES:
            a = dc.down_plan(dtype, B, T, cin, c, dils)
            dc.down_plan.cache_clear()
            assert a == dc.down_plan(dtype, B, T, cin, c, dils)
            assert all(isinstance(v, (int, str)) for v in a.values())
    # every width and reach the kernel takes holds a tile
    for cin in (1, 7, 24, 96, 192):
        for c in (1, 24, 100, 192):
            for dils in ((1, 2, 4), (1, 15, 16), (30, 1, 1)):
                assert dc.down_chain_takes(cin, c, dils)
                for v in ("mma", "ffma"):
                    assert dc.max_tile(v, cin, c, dils) >= 1
    for cin, c, dils in ((193, 24, (1, 2, 4)), (24, 193, (1, 2, 4)),
                         (24, 48, (1, 16, 16)), (24, 48, (1, 2))):
        assert not dc.down_chain_takes(cin, c, dils)


def test_down_chain_instances_are_ones_the_source_compiles():
    """The dispatch names an mma instance for each column count the plans
    give (NT 3 at 24 padded columns, else 6) and the ffma one; the
    constants the plans mirror are the source's."""
    src = _source("down_chain.cu")
    ids = re.search(r"enum \{ kDcMma = (\d+), kDcFfma = (\d+) \}",
                    src).groups()
    assert ids == tuple(str(dc.DOWN_VARIANTS[v]) for v in ("mma", "ffma"))
    mma_nt = {int(n) for n in re.findall(r"variant == kDcMma && nt == (\d+)",
                                         src)}
    assert mma_nt == {3, 6}
    assert "if (variant == kDcFfma)" in src
    assert {dc._nt(c) for c in range(1, 193)} == mma_nt
    for name, value in (("kMaxChannels", dc.MAX_CHANNELS),
                        ("kMaxReach", dc.MAX_REACH),
                        ("kMaxMt", dc._MAX_MT), ("kMaxRpt", dc._MAX_RPT),
                        ("kMaxTile", dc._MAX_TILE),
                        ("kMmaCh", dc._CHUNK["mma"]),
                        ("kFfCh", dc._CHUNK["ffma"]),
                        ("kThreads", dc._THREADS)):
        assert _constant(src, name) == value, name
    assert "kChLd = kMmaCh + 8" in src and dc._CHUNK_LD == 40


def test_down_plan_mirrors_the_sources_formulas(tmp_path):
    """ops/down_chain.py mirrors down_chain.cu's tile and shared-memory
    formulas (dc_max_tile, dc_smem_bytes, dc_pack_off): the source's own
    constants and host-side functions, cut out of it and compiled for the
    host, give the mirror's numbers at chip_smoke's shapes, the CUDA tests'
    and the limits, in both variants."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the source's formulas")
    src = _source("down_chain.cu")
    start = src.index("constexpr int kThreads = 256;")
    end = src.index("template <typename T> __device__ __forceinline__ "
                    "float round_to")
    cases = sorted({(cin, c, dils) for _, _, cin, c, dils in DOWN_PLAN_CASES}
                   | {(cin, c, (1, 2, 4)) for cin in (1, 7, 96, 192)
                      for c in (1, 24, 100, 192)})
    rows = "\n".join(f"  {{{cin}, {c}, {{{d[0]}, {d[1]}, {d[2]}}}}},"
                     for cin, c, d in cases)
    prog = tmp_path / "dc_formulas.cc"
    prog.write_text(
        "#include <algorithm>\n#include <cstddef>\n#include <cstdio>\n"
        "#define __host__\n#define __device__\n"
        + src[start:end] + """
struct Case { int cin, c; long long dil[3]; };
int main() {
  const Case cases[] = {
""" + rows + """
  };
  for (const Case& k : cases)
    for (int mma = 1; mma >= 0; --mma) {
      const int S = dc_max_tile(mma, k.cin, k.c, k.dil);
      const int H = (int)(k.dil[0] + k.dil[1] + k.dil[2]);
      std::printf("%d %zu %lld\\n", S,
                  dc_smem_bytes(mma, std::max(S, 1), H, k.cin, k.c),
                  dc_pack_off(mma, 4, k.cin, k.c));
    }
}
""")
    exe = tmp_path / "dc_formulas"
    subprocess.run([cxx, "-std=c++17", "-O1", "-o", str(exe), str(prog)],
                   check=True, capture_output=True)
    got = subprocess.run([str(exe)], check=True, capture_output=True,
                         text=True).stdout.split("\n")
    want = []
    for cin, c, dils in cases:
        for variant in ("mma", "ffma"):
            S = dc.max_tile(variant, cin, c, dils)
            want.append(f"{S} "
                        f"{dc.smem_bytes(variant, max(S, 1), sum(dils), cin, c)}"
                        f" {dc.pack_elems(variant, cin, c)}")
    assert got[:len(want)] == want
