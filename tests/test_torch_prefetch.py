"""The port's host prefetching (`data/prefetch.py`) against the JAX
package's, and `--resume` bit for bit with the prefetch thread on.

- `PrefetchIterator`: the source's items in order, as JAX's iterator
  gives them, the end of a finite source, and an error in the source
  raised at the `next` that would have returned the item it stopped;
  each item with the state it was made with while the interpreter
  switches threads every microsecond.
- The random state it records with each batch: after n batches taken it
  is the state a batcher has after n `sample_batch` calls, however far the
  thread ran ahead, and `close` puts the batcher back there.
- `BatcherPool`: one thread gives the seeded batcher's stream, as JAX's
  pool does; two threads give two seeded streams, interleaved.
- The trainer saves the state of the first batch not taken: a run of 6
  steps and a resume to 12 equal a run of 12, one step a call, and the
  checkpoint's batcher state is that of 6 batches taken.

Sizes are test_torch_train.py's (200-sample crops, batch 2).
"""

import sys
import time

import numpy as np
import pytest
import torch

from svcc23_fastsvc_tpu.data.collate import FastSVCBatcher as JaxBatcher
from svcc23_fastsvc_tpu.data.prefetch import BatcherPool as JaxPool
from svcc23_fastsvc_tpu.data.prefetch import PrefetchIterator as JaxPrefetch
from svcc23_fastsvc_tpu_torch.data.collate import FastSVCBatcher
from svcc23_fastsvc_tpu_torch.data.prefetch import BatcherPool, PrefetchIterator
from test_torch_train import HOP, _utterances
from test_torch_train_multi_step import _same_state, _train


def _batcher(seed=4):
    return FastSVCBatcher(_utterances(), batch_size=2, batch_length=200,
                          hop_size=HOP, seed=seed)


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], k)


def test_prefetch_order_and_end_match_jax():
    items = [{"x": np.full(3, i)} for i in range(7)]
    port = list(PrefetchIterator(iter(items), depth=2))
    ref = list(JaxPrefetch(iter(items), depth=2))
    assert [int(b["x"][0]) for b in port] == list(range(7))
    for a, b in zip(port, ref):
        _equal(a, b)
    it = PrefetchIterator(iter(items[:1]), depth=3)
    next(it)
    for _ in range(2):  # an ended iterator stays ended
        with pytest.raises(StopIteration):
            next(it)


def test_prefetch_raises_the_source_error_in_place():
    def source():
        for i in range(3):
            yield i
        raise ValueError("bad utterance")

    for cls in (PrefetchIterator, JaxPrefetch):
        it = cls(source(), depth=4)
        assert [next(it) for _ in range(3)] == [0, 1, 2]
        with pytest.raises(ValueError, match="bad utterance"):
            next(it)


def test_each_item_keeps_the_state_it_was_made_with_under_thread_switches():
    """A source whose state is a counter, the interpreter switching
    threads every microsecond: every item comes with the count after it,
    in order, whatever the thread had made meanwhile."""
    class Counter:
        def __init__(self):
            self.n = 0

        def __iter__(self):
            while self.n < 3000:
                self.n += 1
                yield self.n

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        c = Counter()
        it = PrefetchIterator(c, depth=3, state=lambda: c.n)
        for i in range(1, 3001):
            assert next(it) == i and it.state == i
        with pytest.raises(StopIteration):
            next(it)
        it.close()
        assert it._thread is None
    finally:
        sys.setswitchinterval(old)


@pytest.mark.parametrize("taken", [0, 1, 5])
def test_state_is_that_of_the_first_batch_not_taken(taken):
    b = _batcher()
    bg = b.rng.bit_generator
    it = PrefetchIterator(b, depth=4, state=lambda: bg.state,
                          restore=lambda st: setattr(bg, "state", st))
    plain = _batcher()
    for _ in range(taken):
        _equal(next(it), plain.sample_batch())
    # the thread has run ahead of the steps
    deadline = time.monotonic() + 30
    while taken and it._q.qsize() < 4 and time.monotonic() < deadline:
        time.sleep(0.001)
    assert not taken or it._q.qsize() == 4
    assert it.state == plain.rng.bit_generator.state
    it.close()
    assert bg.state == plain.rng.bit_generator.state
    _equal(b.sample_batch(), plain.sample_batch())


def test_batcher_pool_streams_are_the_seeded_batchers():
    one = BatcherPool(_batcher, n_threads=1, depth=3, seed=5)
    ref = JaxPool(lambda s: JaxBatcher(
        [u[1:] for u in _utterances()], batch_size=2, batch_length=200,
        hop_size=HOP, seed=s), n_threads=1, depth=3, seed=5)
    plain = _batcher(5)
    for _ in range(4):
        got = next(one)
        _equal(got, plain.sample_batch())
        _equal(got, next(ref))
    one.close()
    two = BatcherPool(_batcher, n_threads=2, depth=3, seed=5)
    streams = [_batcher(5), _batcher(5 + 7919)]
    want = [[s.sample_batch()["audio"] for _ in range(6)] for s in streams]
    got = [next(two)["audio"] for _ in range(6)]
    two.close()
    # each batch is the next one of one of the two seeded streams
    pos = [0, 0]
    for g in got:
        hit = [i for i in (0, 1) if np.array_equal(g, want[i][pos[i]])]
        assert hit, "a batch of neither stream"
        pos[hit[0]] += 1


def test_resume_with_prefetch_is_bit_for_bit(tmp_path):
    """One step a call with the prefetch thread on: 6 steps, then a resume
    to 12, equal 12 steps in one run (weights, moments, noise, counts);
    the checkpoint at 6 holds the batcher state of 6 batches taken."""
    whole = _train(tmp_path / "whole", 1, 12)
    first = _train(tmp_path / "a", 1, 6)
    ckpt = str(tmp_path / "a" / "checkpoint-6steps.pkl")
    saved = torch.load(ckpt, weights_only=False)["rng"]["batcher"]
    plain = _batcher()
    for _ in range(6):
        plain.sample_batch()
    assert saved == plain.rng.bit_generator.state
    # after the run the batcher stands where the steps left it
    assert first.train_batcher.rng.bit_generator.state == saved
    second = _train(tmp_path / "b", 1, 12, resume=ckpt)
    _same_state(second.task, whole.task)
    assert (second.train_batcher.rng.bit_generator.state
            == whole.train_batcher.rng.bit_generator.state)
