"""The port's native batch assembler (`data/native_batch.py`) against its
numpy version and the JAX package's binding of the same C++ source.

- `assemble_batch`: byte for byte the numpy slice copies and JAX's
  `assemble_batch`, threaded and not; `FastSVCBatcher` takes it.
- `NativeBatchProducer`: at one thread and the same seed, the crops and
  windows of JAX's producer, batch for batch; the `hold` window keeps a
  batch's views valid; `aux_context_window` != 0 is routed to None.
- The library builds into the port's `_build/`, under a hash, and nothing
  is written into `native/`.
- The training CLI's `loader_threads`: 4 gives the native producer with
  hold 2K, a context window gives a `BatcherPool`, 1 the batcher itself.
- The port's `Trainer` on the producer at K = 4 (zero-copy slot views
  stacked for a K-step call) and on a prefetched batcher give the same
  call sizes and step counts.

The store is small (3 utterances of 40 frames, hop 20, 8-dim ppg).
"""

import os

import numpy as np
import pytest

from svcc23_fastsvc_tpu.data import native_batch as jnb
from svcc23_fastsvc_tpu_torch.bin.train_fastsvc import make_train_batcher
from svcc23_fastsvc_tpu_torch.data import native_batch as nb
from svcc23_fastsvc_tpu_torch.data.collate import FastSVCBatcher
from svcc23_fastsvc_tpu_torch.data.prefetch import BatcherPool
from svcc23_fastsvc_tpu_torch.utils import host_build

N, FRAMES, HOP, D, E = 3, 40, 20, 8, 12


def _packed(seed=0):
    r = np.random.default_rng(seed)
    return {
        "audio": r.standard_normal((N, FRAMES * HOP)).astype(np.float32),
        "f0": r.uniform(80, 300, (N, FRAMES)).astype(np.float32),
        "ppg": r.standard_normal((N, FRAMES, D)).astype(np.float32),
        "lft": r.standard_normal((N, FRAMES * HOP)).astype(np.float32),
        "spk_emb": r.standard_normal((N, E)).astype(np.float32),
        "n_frames": np.asarray([FRAMES, 30, 25], np.int64),
    }


def _equal(a, b, keys=None):
    for k in keys or a:
        np.testing.assert_array_equal(a[k], b[k], k)


@pytest.mark.parametrize("B,threads", [(2, 1), (7, 4)])
def test_assemble_batch_is_the_numpy_copies_and_jax(B, threads):
    p = _packed()
    r = np.random.default_rng(B)
    rows = r.integers(0, N, B)
    starts = (r.random(B) * (p["n_frames"][rows] - 10)).astype(np.int64)
    got = nb.assemble_batch(p, rows, starts, 10, HOP, n_threads=threads)
    _equal(got, nb.assemble_batch_plain(p, rows, starts, 10, HOP))
    if not jnb.native_batch_available():
        pytest.fail("the JAX package's libbatch.so did not build")
    _equal(got, jnb.assemble_batch(p, rows, starts, 10, HOP,
                                   n_threads=threads))
    assert got["audio"].shape == (B, 10 * HOP, 1)


def test_producer_matches_jax_at_one_thread():
    kw = dict(batch_size=3, frames=10, hop=HOP, n_threads=1, hold=2, seed=7,
              collect_crops=True)
    port = nb.NativeBatchProducer(_packed(), **kw)
    ref = jnb.NativeBatchProducer(_packed(), **kw)
    try:
        for _ in range(6):
            a, b = next(port), next(ref)
            assert set(a) == set(b)
            _equal(a, b)
            # the windows are the store's at the drawn crops
            want = nb.assemble_batch_plain(_packed(), a["_rows"],
                                           a["_starts"], 10, HOP)
            _equal(a, want, ("audio", "f0", "ppg", "lft"))
            _equal({"e": a["spk_emb"]}, {"e": _packed()["spk_emb"][
                a["_rows"]]})
        assert port.batches == 6
    finally:
        port.close()
        ref.close()


def test_hold_keeps_the_last_batches_valid():
    prod = nb.NativeBatchProducer(_packed(), batch_size=2, frames=10,
                                  hop=HOP, n_threads=2, hold=3, seed=1)
    try:
        first = next(prod)
        copy = {k: v.copy() for k, v in first.items()}
        for _ in range(2):  # hold - 1 more: first is not yet released
            next(prod)
        _equal(first, copy)
    finally:
        prod.close()


def test_context_windows_route_to_none():
    from test_torch_train import _utterances

    b = FastSVCBatcher(_utterances(), batch_size=2, batch_length=200,
                       hop_size=20, aux_context_window=2)
    assert nb.make_native_producer(b) is None


def test_library_builds_into_the_ports_build_dir():
    listing = sorted(os.listdir(host_build.NATIVE_DIR))
    nb._load()
    path = host_build.library_path(nb.SOURCE, "batch", host_build.cxx())
    assert os.path.dirname(path) == host_build.BUILD_DIR
    assert os.path.basename(path).startswith("libbatch_")
    assert os.path.exists(path)
    assert sorted(os.listdir(host_build.NATIVE_DIR)) == listing


def _cli_batcher(loader_threads, acw=0, steps_per_call=8):
    from test_torch_train import _utterances

    cfg = {"loader_threads": loader_threads,
           "steps_per_call": steps_per_call}
    return make_train_batcher(cfg, lambda seed: FastSVCBatcher(
        _utterances(), batch_size=2, batch_length=200, hop_size=20,
        aux_context_window=acw, seed=seed), 3)


def test_cli_loader_threads_pick_the_producer():
    prod = _cli_batcher(4)
    try:
        assert isinstance(prod, nb.NativeBatchProducer)
        assert prod._hold == 16
        assert next(prod)["audio"].shape == (2, 200, 1)
    finally:
        prod.close()
    pool = _cli_batcher(4, acw=1)
    assert isinstance(pool, BatcherPool) and len(pool._threads) == 4
    pool.close()
    assert isinstance(_cli_batcher(1), FastSVCBatcher)


def test_trainer_runs_on_the_producer_at_four_steps_a_call(tmp_path):
    """The port's trainer on the producer (no prefetch wrap) at K = 4, the
    slot views stacked for each call: the calls and steps of a prefetched
    batcher's run, finite losses."""
    from svcc23_fastsvc_tpu_torch.config import build_train_task
    from svcc23_fastsvc_tpu_torch.train.loop import Trainer
    from test_torch_train_multi_step import CFG

    cfg = {**CFG, "steps_per_call": 4, "train_max_steps": 8,
           "log_interval_steps": 8, "save_interval_steps": 8}
    runs = []
    for producer in (True, False):
        task = build_train_task(cfg, device="cpu", seed=3)
        from test_torch_train import _utterances

        b = FastSVCBatcher(_utterances(), batch_size=2, batch_length=200,
                           hop_size=20, seed=4)
        src = nb.make_native_producer(b, n_threads=2, hold=8) if producer \
            else b
        trainer = Trainer(task, src, config=cfg, outdir=str(
            tmp_path / str(producer)))
        try:
            trainer.run()
        finally:
            if producer:
                src.close()
        assert trainer._train_iter is None
        runs.append((trainer.call_sizes, task.step, trainer.history))
    assert runs[0][:2] == runs[1][:2] == ([4, 2, 2], 8)
    for k, v in runs[0][2][-1].items():
        assert np.isfinite(v), k
