"""The port's data parallelism (`svcc23_fastsvc_tpu_torch/parallel/`) on the
CPU: two ranks over gloo against one process on the global batch and
against the JAX package's `jit_train_step_dp` on a 2-device mesh.

The ranks run in two processes that `torch.multiprocessing` spawns once
for the file (`tests/torch_dp_worker.py`, which imports no JAX); they
join through the port's `initialize` and run every case on their rows.
The weights come from the JAX states (`compat/jax_params.py`); the
excitation is fed in the batch, so no noise stream is compared. The
FastSVC shards' audio differs in loudness by 10x, so a spectral
convergence taken per rank and averaged is far from the batch-global one;
the B02 rows' lengths differ across the ranks, so a per-rank masked mean
or per-rank batch-norm statistics are far from the global ones. Widths
are tiny (test_torch_train.py's and test_torch_b02_train.py's). Each
tolerance is stated where it is used.
"""

import os
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from svcc23_fastsvc_tpu.losses import MultiResolutionSTFTLoss as JaxSTFTLoss
from svcc23_fastsvc_tpu.models import tacotron2 as jt
from svcc23_fastsvc_tpu.models.fastsvc import FastSVCGenerator as JaxGen
from svcc23_fastsvc_tpu.models.fastsvc import (
    MelGANMultiScaleDiscriminator as JaxMSD,
)
from svcc23_fastsvc_tpu.ops import conv as jconv
from svcc23_fastsvc_tpu.ops.signal_gen import SignalGenerator as JaxSigGen
from svcc23_fastsvc_tpu.parallel import jit_train_step_dp as jax_dp_step
from svcc23_fastsvc_tpu.parallel import make_mesh as jax_mesh
from svcc23_fastsvc_tpu.parallel import replicate as jax_replicate
from svcc23_fastsvc_tpu.parallel import shard_batch as jax_shard
from svcc23_fastsvc_tpu.train import FastSVCTrainTask as JaxTask
from svcc23_fastsvc_tpu.train import make_optimizer
from svcc23_fastsvc_tpu.train.b02 import B02TrainTask as JaxB02Task
from svcc23_fastsvc_tpu_torch.compat import (
    generator_state_dict_from_jax,
    melgan_msd_state_dict_from_jax,
    subfreq_discriminator_state_dict_from_jax,
    tacotron2_state_dict_from_jax,
)
from svcc23_fastsvc_tpu_torch.data.wire import to_device
from svcc23_fastsvc_tpu_torch.losses import MultiResolutionSTFTLoss
from svcc23_fastsvc_tpu_torch.parallel import (
    HostShardedBatcher,
    global_batch,
    initialize,
    make_mesh,
    shard_batch,
    shard_stacked_batch,
)
from svcc23_fastsvc_tpu_torch.parallel.distributed import backend_for
from svcc23_fastsvc_tpu_torch.parallel.mesh import dp_impl, pmean

import torch_dp_worker as worker

WORLD = 2
B = 4  # global rows, 2 a rank
TIMEOUT_S = 240


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _fastsvc_batch(seed, Tf=10):
    """Rank 0's rows at amplitude 0.3, rank 1's at 0.03."""
    r = np.random.default_rng(seed)
    T = Tf * worker.HOP
    t = np.arange(T) / worker.SR
    loud = np.repeat([0.3, 0.03], B // WORLD)[:, None]
    audio = loud * (np.sin(2 * np.pi * 220 * t) + 0.1 * r.standard_normal(
        (B, T)))
    return {
        "ppg": r.standard_normal((B, Tf, 8)).astype(np.float32),
        "f0": np.full((B, Tf, 1), 220.0, np.float32),
        "lft": (0.1 * r.standard_normal((B, T, 1))).astype(np.float32),
        "spk_emb": r.standard_normal((B, 12)).astype(np.float32),
        "audio": audio[..., None].astype(np.float32),
        "sine": (0.1 * r.standard_normal((B, T, 1))).astype(np.float32),
    }


B02_LENGTHS = [24, 21, 9, 13]  # rank 0 holds 45 valid frames, rank 1 22


def _b02_batch(seed):
    r = np.random.default_rng(seed)
    T = worker.B02_T
    return {
        "ppg": r.standard_normal((B, T, 16)).astype(np.float32),
        "lft": (0.3 * r.standard_normal((B, T, 1))).astype(np.float32),
        "lf0": (5 + 0.3 * r.standard_normal((B, T, 1))).astype(np.float32),
        "spk_emb": r.standard_normal((B, 8)).astype(np.float32),
        "targets": (0.5 * r.standard_normal((B, T, 63))).astype(np.float32),
        "lengths": np.asarray(B02_LENGTHS, np.int32),
    }


def _jax_fastsvc():
    jtask = JaxTask(
        generator=JaxGen(**worker.GEN), discriminator=JaxMSD(**worker.DIS),
        g_tx=make_optimizer(lr=1e-3, grad_norm=10.0),
        d_tx=make_optimizer(lr=1e-3, grad_norm=1.0),
        signal_generator=JaxSigGen(sample_rate=worker.SR,
                                   hop_size=worker.HOP),
        stft_loss=JaxSTFTLoss(*worker.STFT))
    return jtask, jtask.init_state(jax.random.PRNGKey(6))


def _jax_b02():
    jtask = JaxB02Task(
        generator=jt.Tacotron2(**worker.B02_SMALL),
        discriminator=jt.MultiSubFreqDiscriminator(
            batch_max_frames=worker.B02_T),
        g_tx=make_optimizer(lr=1e-3, grad_norm=1.0),
        d_tx=make_optimizer(lr=1e-3, grad_norm=1.0))
    return jtask, jtask.init_state(jax.random.PRNGKey(6))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The inputs, the JAX states, and what each rank's worker returned."""
    workdir = str(tmp_path_factory.mktemp("torch_dp"))
    jtask, jstate = _jax_fastsvc()
    btask, bstate = _jax_b02()
    inp = {
        "fastsvc": {
            "g": generator_state_dict_from_jax(_np(jstate.g_params)),
            "d": melgan_msd_state_dict_from_jax(_np(jstate.d_params))},
        "b02": {
            "g": tacotron2_state_dict_from_jax(_np(bstate.g_params)),
            "d": subfreq_discriminator_state_dict_from_jax(
                _np(bstate.d_params))},
        "batches": [_fastsvc_batch(7), _fastsvc_batch(8)],
        "k_batches": [_fastsvc_batch(20 + i) for i in range(worker.K)],
        # T = 400 samples: past the fused conv's gate, as JAX's test
        "long_batch": _fastsvc_batch(30, Tf=20),
        "b02_batch": _b02_batch(40),
    }
    torch.save(inp, os.path.join(workdir, "inputs.pt"))
    ctx = mp.start_processes(worker.run, args=(WORLD, _free_port(), workdir),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, "the ranks did not finish"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)
    ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                        weights_only=False) for r in range(WORLD)]
    return {"inp": inp, "ranks": ranks, "jax": (jtask, jstate),
            "jax_b02": (btask, bstate)}


def _rel(got, want):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = want.detach().double().numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _same_on_every_rank(ranks, key):
    for name in ("g", "d"):
        a, b = ranks[0][key][name], ranks[1][key][name]
        for k in a:
            assert torch.equal(a[k], b[k]), (key, name, k)


def _update_l2(got: dict, want: dict, start: dict) -> float:
    """The relative L2 distance of a whole model's update from `want`'s
    (weights only; the batch norms' running statistics are held apart)."""
    keys = [k for k, v in want.items() if "running" not in k
            and torch.as_tensor(np.asarray(v)).is_floating_point()]

    def flat(sd):
        return torch.cat([torch.as_tensor(np.asarray(sd[k])).reshape(-1)
                          .double() for k in keys])

    for k in keys:
        assert torch.isfinite(got[k]).all(), k
    u_got, u_want = flat(got) - flat(start), flat(want) - flat(start)
    return ((u_got - u_want).norm() / u_want.norm()).item()


def _port_single_fastsvc(dp):
    """One process, the global batches: gen_step then gan_step."""
    task = worker.fastsvc_task(dp["inp"]["fastsvc"])
    metrics = [task.gen_step(to_device(dp["inp"]["batches"][0], "cpu")),
               task.gan_step(to_device(dp["inp"]["batches"][1], "cpu"))]
    return metrics, worker.state(task)


# f32 throughout. The gan_step follows the gen_step, so its gradient is
# taken at weights that already differ by round-off, and the STFT loss's
# gradient is ill-conditioned (ROADMAP: f32 gradients a median 1.1% from
# f64): the weights are held as a whole, by the relative L2 distance of
# each model's update, as test_torch_trainer_trajectory.py holds them.
# Measured here: the ranks against one port process (the two halves' sums
# added in another order) losses 2.1e-6, G 6.8e-4, D 2.1e-5; against JAX's
# 2-device GSPMD steps losses 2.9e-5, G 9.1e-3, D 5.7e-5 (one port
# process against JAX: G 8.4e-3). Tolerances: 10x each.
SINGLE_TOL = {"loss": 3e-5, "g": 7e-3, "d": 3e-4}
JAX_TOL = {"loss": 3e-4, "g": 0.1, "d": 6e-4}


def test_fastsvc_steps_equal_one_process_and_jax_dp(dp):
    ranks = dp["ranks"]
    _same_on_every_rank(ranks, "fastsvc")
    for r in ranks:  # the metrics are the group's mean on every rank
        for m0, m1 in zip(ranks[0]["metrics"], r["metrics"]):
            assert all(torch.equal(m0[k], m1[k]) for k in m0)
    got = ranks[0]
    start = dp["inp"]["fastsvc"]

    metrics, single = _port_single_fastsvc(dp)
    for phase, mg, ms in zip(("gen", "gan"), got["metrics"], metrics):
        assert set(mg) == set(ms)
        for k in ms:
            assert _rel(mg[k], ms[k]) < SINGLE_TOL["loss"], (phase, k)
    for name in ("g", "d"):
        d = _update_l2(got["fastsvc"][name], single[name], start[name])
        assert d < SINGLE_TOL[name], (name, d)

    jtask, state = dp["jax"]
    saved = jconv._PALLAS_CONV_MODE  # jit_train_step_dp sets it to "0"
    try:
        mesh = jax_mesh(WORLD)
        state = jax_replicate(state, mesh)
        for i, phase in enumerate(("gen", "gan")):
            step = jax_dp_step(getattr(jtask, f"{phase}_step"), mesh,
                               donate=False)
            batch = {k: jnp.asarray(v)
                     for k, v in dp["inp"]["batches"][i].items()}
            state, jm = step(state, jax_shard(batch, mesh))
            assert set(jm) == set(got["metrics"][i])
            for k in jm:
                assert _rel(got["metrics"][i][k], jm[k]) < JAX_TOL["loss"], \
                    (phase, k)
    finally:
        jconv.set_pallas_conv_mode(saved)
    for name, want in (
            ("g", generator_state_dict_from_jax(_np(state.g_params))),
            ("d", melgan_msd_state_dict_from_jax(_np(state.d_params)))):
        d = _update_l2(got["fastsvc"][name], want, start[name])
        assert d < JAX_TOL[name], (name, d)


def test_spectral_convergence_is_batch_global(dp):
    """On the gen_step's batch and the starting generator's output, the
    loudness skew puts a per-rank ratio, averaged, more than 10x the
    losses' tolerance from the batch-global ratio; the data-parallel
    gen_step's value is the global one."""
    b = to_device(dp["inp"]["batches"][0], "cpu")
    gen = worker.fastsvc_task(dp["inp"]["fastsvc"]).generator
    with torch.no_grad():
        y_hat = gen(b["ppg"], b["sine"], b["lft"], b["spk_emb"])[..., 0]
    y = b["audio"][..., 0]
    loss = MultiResolutionSTFTLoss(*worker.STFT)
    sc_global = loss(y_hat, y)[0]
    rows = B // WORLD
    per_rank = torch.stack([loss(y_hat[i:i + rows], y[i:i + rows])[0]
                            for i in range(0, B, rows)]).mean()
    assert _rel(per_rank, sc_global) > 10 * SINGLE_TOL["loss"]
    got = dp["ranks"][0]["metrics"][0]["spectral_convergence_loss"]
    assert _rel(got, sc_global) < SINGLE_TOL["loss"]


def test_k_step_call_equals_k_dp_steps(dp):
    """One K = 3 call (`jit_multi_step_dp`) and 3 calls of the DP step on
    the same rows: the same arithmetic in the same order, so equal bits,
    as JAX's test_dp_multi_step_matches_sequential_dp holds its two."""
    for r in dp["ranks"]:
        for i, m in enumerate(r["k_seq_metrics"]):
            for k, v in m.items():
                assert torch.equal(r["k_metrics"][k][i], v), (i, k)
        for name in ("g", "d"):
            for k, v in r["k_seq"][name].items():
                assert torch.equal(r["k_call"][name][k], v), (name, k)


def test_fused_conv_switch_under_dp(dp):
    """`FASTSVC_PALLAS_CONV=1` under data parallelism against it off, as
    JAX's test_shard_map_dp_runs_pallas_conv: the switch on must route the
    step's convs to the fused conv (its plain version here), and the two
    lowerings may sum in other orders, so losses within 1e-4 and each
    model's update within 1e-3 relative L2 (on the CPU both plain versions
    do the same arithmetic and agree bit for bit)."""
    for r in dp["ranks"]:
        assert r["fused_calls"] == {"0": 0, "1": r["fused_calls"]["1"]}
        assert r["fused_calls"]["1"] > 0
        for k, v in r["conv0_metrics"].items():
            assert _rel(r["conv1_metrics"][k], v) < 1e-4, k
        for name in ("g", "d"):
            d = _update_l2(r["conv1"][name], r["conv0"][name],
                           dp["inp"]["fastsvc"][name])
            assert d < 1e-3, (name, d)
    _same_on_every_rank(dp["ranks"], "conv1")


# B02, f32, one gen_step: the running statistics after it and the losses
# 1e-5 relative (test_torch_b02_train.py's f32 rule); the update of the
# whole generator by relative L2, measured at 6.8e-8 against one port
# process and 2.8e-7 against JAX's 2-device GSPMD step, held to 10x.
# The lengths differ across the ranks (45 and 22 valid frames), so a
# per-rank masked mean or per-rank batch-norm statistics would miss.
B02_SINGLE_L2 = 1e-6
B02_JAX_L2 = 3e-6


def test_b02_gen_step_equals_one_process_and_jax_dp(dp):
    ranks = dp["ranks"]
    _same_on_every_rank(ranks, "b02")
    got = ranks[0]
    start = dp["inp"]["b02"]
    task = worker.b02_task(start)
    single = task.gen_step(to_device(dp["inp"]["b02_batch"], "cpu"))
    for k in single:
        assert _rel(got["b02_metrics"][k], single[k]) < 1e-5, k
    want = worker.state(task)["g"]
    stats = [k for k in want if "running" in k]
    assert stats
    for k in stats:
        assert _rel(got["b02"]["g"][k], want[k]) < 1e-5, k
    d = _update_l2(got["b02"]["g"], want, start["g"])
    assert d < B02_SINGLE_L2, d

    jtask, state = dp["jax_b02"]
    saved = jconv._PALLAS_CONV_MODE
    try:
        mesh = jax_mesh(WORLD)
        step = jax_dp_step(jtask.gen_step, mesh, donate=False)
        batch = {k: jnp.asarray(v) for k, v in dp["inp"]["b02_batch"].items()}
        state, jm = step(jax_replicate(state, mesh), jax_shard(batch, mesh))
    finally:
        jconv.set_pallas_conv_mode(saved)
    for k in jm:
        assert _rel(got["b02_metrics"][k], jm[k]) < 1e-5, k
    for i, s in enumerate(state.g_bn["encoder"]):
        for stat in ("mean", "var"):
            assert _rel(got["b02"]["g"][f"encoder.convs.{i}.1.running_{stat}"],
                        s[stat]) < 1e-5, (i, stat)
    for stat in ("mean", "var"):
        assert _rel(got["b02"]["g"][f"bap_decoder.10.running_{stat}"],
                    state.g_bn["bap"][stat]) < 1e-5, stat
    d = _update_l2(got["b02"]["g"],
                   tacotron2_state_dict_from_jax(_np(state.g_params)),
                   start["g"])
    assert d < B02_JAX_L2, d


def test_shard_map_forward_dp_equals_the_plain_forward(dp):
    """Each rank's forward of its rows, gathered: the whole batch's output
    on every rank, within 1e-6 of one forward (the same convs on fewer
    rows)."""
    gen = worker.fastsvc_task(dp["inp"]["fastsvc"]).generator
    b = to_device(dp["inp"]["batches"][0], "cpu")
    with torch.no_grad():
        want = gen(b["ppg"], b["sine"], b["lft"], b["spk_emb"])
    for r in dp["ranks"]:
        assert r["forward"].shape == want.shape
        assert _rel(r["forward"], want) < 1e-6


def test_shard_batch_takes_each_ranks_rows_and_make_mesh_counts():
    """Without a process group: one rank, the whole batch; more devices
    than ranks raise, as JAX's make_mesh does; `dp_impl` checks its name."""
    assert make_mesh() is None and make_mesh(1) is None
    with pytest.raises(ValueError, match="requested 2 devices"):
        make_mesh(2)
    batch = {"x": np.arange(12).reshape(6, 2), "none": None}
    assert np.array_equal(shard_batch(batch, None)["x"], batch["x"])
    stacked = {"x": np.arange(24).reshape(2, 6, 2)}
    assert np.array_equal(shard_stacked_batch(stacked, None)["x"],
                          stacked["x"])
    for impl in ("auto", "gspmd", "shard_map"):
        assert dp_impl({"dp_impl": impl}) == impl
    assert dp_impl({}) == "auto"
    with pytest.raises(ValueError, match="dp_impl"):
        dp_impl({"dp_impl": "pmap"})


def test_initialize_picks_the_backend_and_never_switches(monkeypatch):
    """NCCL for CUDA, gloo for the CPU, `SVC_DIST_BACKEND` naming either;
    NCCL asked for on the CPU raises instead of running gloo; one process
    starts no group; a rank's batcher draws from seed + 1000 * rank."""
    for var in ("SVC_DIST_BACKEND", "SVC_NUM_PROCESSES", "SVC_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert backend_for("cpu") == "gloo" and backend_for("cuda") == "nccl"
    monkeypatch.setenv("SVC_DIST_BACKEND", "gloo")
    assert backend_for("cuda") == "gloo"
    monkeypatch.setenv("SVC_DIST_BACKEND", "mpi")
    with pytest.raises(ValueError, match="SVC_DIST_BACKEND"):
        backend_for("cpu")
    monkeypatch.setenv("SVC_DIST_BACKEND", "nccl")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        initialize("127.0.0.1:1", 2, 0, device="cpu")
    assert initialize(None, 1, 0, device="cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    batch = {"x": np.zeros((2, 3))}
    assert global_batch(batch) is batch
    assert list(HostShardedBatcher(lambda seed: [seed], seed=7)) == [7]


def test_one_rank_group_gives_one_process_bits(dp):
    """A data group of one rank (gloo, in this process): the gen_step and
    gan_step give one process's bits, metrics and weights, as chip_smoke
    30(b) holds one NCCL rank's captured calls on the card. The mean of
    the gradients keeps their strides: D's optimizer clips on a norm that
    sums in memory order, and autograd hands some of D's gradients back
    non-contiguous."""
    import torch.distributed as dist

    dist.init_process_group("gloo",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        t = torch.arange(12.0).reshape(3, 4).t()  # non-contiguous
        (mean,) = pmean([t], dist.group.WORLD)
        assert torch.equal(mean, t) and mean.stride() == t.stride()
        runs = []
        for group in (None, dist.group.WORLD):
            task = worker.fastsvc_task(dp["inp"]["fastsvc"], dp_group=group)
            metrics = [task.gen_step(to_device(dp["inp"]["batches"][0],
                                               "cpu")),
                       task.gan_step(to_device(dp["inp"]["batches"][1],
                                               "cpu"))]
            runs.append((metrics, worker.state(task)))
    finally:
        dist.destroy_process_group()
    (m0, s0), (m1, s1) = runs
    for a, b in zip(m0, m1):
        assert all(torch.equal(a[k], b[k]) for k in a)
    for name in ("g", "d"):
        for k, v in s0[name].items():
            assert torch.equal(v, s1[name][k]), (name, k)
