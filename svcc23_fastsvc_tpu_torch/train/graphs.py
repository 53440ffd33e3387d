"""K training steps as one captured CUDA graph.

The card's counterpart of the JAX trainer's K steps in one `lax.scan`
program (`svcc23_fastsvc_tpu/train/gan.py::make_multi_step`): the host
issues a training step's launches one by one (~10^4 for FastSVC, ~10^5
for B02's recurrences) and keeps the card idle much of the time, so
`StepGraphs` captures a task's `run_steps` over k steps once and replays
it. The task is a `train.gan.FastSVCTrainTask` or a
`train.b02.B02TrainTask`: both hold `generator`, `discriminator`, `g_opt`,
`d_opt` and `rng`, and give `coefficient_table`, `run_steps` and
`advance`. It holds
one `torch.cuda.CUDAGraph` per (phase, k, batch field shapes and dtypes),
captured at first use, all in one memory pool: the graphs run one after
another on one stream, so each may reuse what the others freed.

- Inputs. One device buffer holds the stacked batch's fields and the
  optimizers' (2, k, 4) coefficient table (`coefficient_table`); the graph
  reads them there. A call fills a pinned host buffer (two, in turns, so
  filling one waits only on the copy before last) and sends it with one
  host-to-device copy.
- Warm-up. Before capture, one eager step of the phase runs on the side
  stream the capture uses, so that lazy set-up (the optimizer's moments,
  library handles, plans and workspaces, the kernels' attributes) happens
  outside the graph. The models', moments' and noise generator's state is
  saved before it and put back after, so it leaves training where it was.
- Noise. The task's generator (FastSVC's excitation noise, B02's dropout
  masks and window starts) is registered with each graph: a replay draws
  the numbers k eager steps would draw next.
- Outputs. The metrics, (k, n) in the graph's memory; each call returns a
  clone, as the next replay writes over them.
- Data parallelism. A task with a `dp_group` all-reduces its gradients
  and metrics inside each step, so the graph holds those collectives.
  Only NCCL can be captured; the eager warm-up step is the first call of
  each collective, so the communicator and its buffers exist before the
  capture starts. A gloo group raises here: on the card a K-step call
  never falls back to eager steps.
- Addresses. A graph holds the addresses of the parameters and moments it
  updates. Loading a checkpoint copies into them in place; a replay checks
  that none was rebound since the capture, and raises if one was.

A capture that fails raises; nothing falls back to eager steps.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_ALIGN = 256  # bytes; every field of the input buffer starts on it


def _state_tensors(task) -> list:
    """What a training step writes in place: parameters, buffers, moments."""
    out = []
    for m in (task.generator, task.discriminator):
        out += list(m.parameters()) + list(m.buffers())
    for opt in (task.g_opt, task.d_opt):
        out += opt.mu + opt.nu
    return out


class _Graph:
    """One captured k-step call: its input buffers, graph and outputs."""

    def __init__(self, phase: str, k: int, spec: tuple, device):
        self.phase, self.k = phase, k
        self.fields, size = [], 0
        for name, shape, dtype in spec:
            nbytes = dtype.itemsize
            for n in shape:
                nbytes *= n
            self.fields.append((name, size, nbytes, shape, dtype))
            size += -(-nbytes // _ALIGN) * _ALIGN
        self.hosts = [torch.empty(size, dtype=torch.uint8, pin_memory=True)
                      for _ in range(2)]
        self.sent = [None, None]  # the event after each host buffer's copy
        self.turn = 0
        self.device_buf = torch.empty(size, dtype=torch.uint8, device=device)
        self.inputs = {name: self._view(self.device_buf, name)
                       for name, *_ in self.fields}
        self.graph = None
        self.names = self.out = self.addresses = None

    def _view(self, buf, name):
        for n, off, nbytes, shape, dtype in self.fields:
            if n == name:
                return buf[off:off + nbytes].view(dtype).view(shape)
        raise KeyError(name)

    def send(self, arrays: dict):
        """Fill the next pinned buffer from host arrays and copy it to the
        device buffer: one transfer, on the current stream."""
        i = self.turn
        self.turn ^= 1
        if self.sent[i] is not None:
            self.sent[i].synchronize()  # its last copy has left
        for name, *_ in self.fields:
            self._view(self.hosts[i], name).copy_(arrays[name])
        self.device_buf.copy_(self.hosts[i], non_blocking=True)
        self.sent[i] = torch.cuda.Event()
        self.sent[i].record()


class StepGraphs:
    """Captured k-step calls of one train task on the card.

    `stage(phase, batches)` sends k stacked host batches and the
    optimizers' next k coefficients to the device; `replay(graph)` runs
    them (capturing first if the graph is new), counts the k steps on the
    host and returns the metrics, (k,) device tensors.
    """

    COEFS = "__coefficients__"

    def __init__(self, task):
        self.task = task
        self.device = task.device
        if self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA task, not "
                             f"{self.device}")
        group = getattr(task, "dp_group", None)
        if group is not None and dist.get_backend(group) != "nccl":
            raise ValueError(
                f"a captured K-step call all-reduces inside its graph, and "
                f"only NCCL collectives can be captured; this data group is "
                f"{dist.get_backend(group)}: train with steps_per_call 1 or "
                f"over NCCL")
        self.stream = torch.cuda.Stream(self.device)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: dict = {}

    def stage(self, phase: str, batches: dict) -> _Graph:
        arrays = {name: torch.as_tensor(v) for name, v in batches.items()}
        k = next(iter(arrays.values())).shape[0]
        arrays[self.COEFS] = torch.from_numpy(self.task.coefficient_table(k))
        spec = tuple((name, tuple(t.shape), t.dtype)
                     for name, t in sorted(arrays.items()))
        key = (phase, k, spec)
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = _Graph(phase, k, spec, self.device)
        graph.send(arrays)
        return graph

    def replay(self, graph: _Graph) -> dict:
        if graph.graph is None:
            self._capture(graph)
        if [t.data_ptr() for t in _state_tensors(self.task)] \
                != graph.addresses:
            raise RuntimeError(
                "a parameter or optimizer moment was rebound since the "
                "graph was captured; load checkpoints in place")
        graph.graph.replay()
        out = graph.out.clone()
        self.task.advance(graph.phase, graph.k)
        return {name: out[:, j] for j, name in enumerate(graph.names)}

    def _run(self, graph: _Graph, k: int):
        batches = {name: t[:k] for name, t in graph.inputs.items()
                   if name != self.COEFS}
        return self.task.run_steps(graph.phase, batches,
                                   graph.inputs[self.COEFS][:, :k])

    def _capture(self, graph: _Graph):
        task = self.task
        for opt in (task.g_opt, task.d_opt):
            opt._init_state()
        state = _state_tensors(task)
        saved = [t.detach().clone() for t in state]
        rng = task.rng.get_state() if task.rng is not None else None
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            self._run(graph, 1)  # the warm-up step
        current.wait_stream(self.stream)
        with torch.no_grad():
            for t, s in zip(state, saved):
                t.copy_(s)
        if rng is not None:
            task.rng.set_state(rng)
        del saved
        cuda_graph = torch.cuda.CUDAGraph()
        if task.rng is not None:
            cuda_graph.register_generator_state(task.rng)
        with torch.cuda.graph(cuda_graph, pool=self.pool, stream=self.stream):
            metrics = self._run(graph, graph.k)
            names = list(metrics)
            out = torch.stack([metrics[n] for n in names], dim=1)
        graph.graph, graph.names, graph.out = cuda_graph, names, out
        graph.addresses = [t.data_ptr() for t in _state_tensors(task)]
