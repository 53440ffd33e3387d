"""Data-parallel training over a 1-D group of ranks.

Counterpart of `svcc23_fastsvc_tpu/parallel/mesh.py`. The JAX package
shards the batch over a 1-D ("data",) `Mesh` and replicates the train
state; it has two lowerings of that step: GSPMD (`jit_train_step_dp`,
where XLA inserts the gradient all-reduce but cannot partition the fused
Pallas convs) and `shard_map` (`shard_map_step_dp`, a per-shard step with
explicit `pmean`s that keeps them). Under torch the split is gone: every
rank is a process that runs the task's own step on its local rows, with
the task's `dp_group` set, and the step averages the gradients (one flat
buffer and one all-reduce a player, before the optimizer so that its
clipping sees the global gradient) and the metrics across the group. The
hand-written kernels run as they are on each rank's rows. So
`jit_train_step_dp`, `jit_multi_step_dp` and `shard_map_step_dp` all
return that one step, and the config's `dp_impl` (auto | gspmd |
shard_map) is checked and names it.

The mesh is a `torch.distributed` process group of the first n ranks (the
whole world by default), or None for one process without a group. The
couplings across the batch that a global step has stay global: the STFT
loss's spectral convergence (`losses.stft_loss`), B02's masked MSE and
its batch norms' statistics (`losses.masked`, `models.tacotron2`) sum
their parts across the group with `psum`, whose gradient is the
all-reduce of the cotangents, as JAX's psum transposes to psum.

The models are < 10 M parameters, so data parallelism is the whole
scaling story, as in JAX.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.distributed as dist

DP_IMPLS = ("auto", "gspmd", "shard_map")


def make_mesh(n_devices: Optional[int] = None):
    """The data group of the first `n_devices` ranks (all by default): the
    default group for the whole world, None for one process without a
    process group. Raises when asked for more ranks than there are."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n_devices is None else n_devices
    if n > world:
        raise ValueError(f"requested {n} devices but only {world} present")
    if not dist.is_initialized():
        return None
    if n == world:
        return dist.group.WORLD
    return dist.new_group(list(range(n)))


def mesh_rank(mesh) -> int:
    """This rank's index in the group (0 without one)."""
    return 0 if mesh is None else dist.get_rank(mesh)


def mesh_size(mesh) -> int:
    """The number of ranks in the group (1 without one)."""
    return 1 if mesh is None else dist.get_world_size(mesh)


def _rows(v, mesh, axis: int):
    if v is None:
        return None
    size, rank = mesh_size(mesh), mesh_rank(mesh)
    n = v.shape[axis]
    if n % size:
        raise ValueError(f"{n} rows do not split over {size} ranks")
    k = n // size
    index = (slice(None),) * axis + (slice(rank * k, (rank + 1) * k),)
    return v[index]


def _place(batch: dict, device):
    if device is None:
        return batch
    from ..data.wire import to_device

    return to_device(batch, device)


def shard_batch(batch: dict, mesh, *, device=None) -> dict:
    """This rank's rows of a global batch dict (numpy arrays or tensors,
    batch on the leading axis): rank r of W takes the r-th of W equal
    runs of rows, as JAX's sharding over the data axis places them; on
    `device` if given."""
    return _place({k: _rows(v, mesh, 0) for k, v in batch.items()}, device)


def shard_stacked_batch(batches: dict, mesh, *, device=None) -> dict:
    """`shard_batch` for K stacked batches: the leading K axis whole, the
    batch axis (axis 1) split over the ranks."""
    return _place({k: _rows(v, mesh, 1) for k, v in batches.items()},
                  device)


def _state_tensors(task) -> list:
    out = []
    for m in (task.generator, task.discriminator):
        out += list(m.parameters()) + list(m.buffers())
    for opt in (task.g_opt, task.d_opt):
        if opt.mu is not None:
            out += opt.mu + opt.nu
    return out


@torch.no_grad()
def replicate(task, mesh):
    """Give every rank rank 0's parameters, buffers and optimizer moments
    (those that exist yet), in place; returns the task."""
    if mesh is None:
        return task
    src = dist.get_global_rank(mesh, 0)
    for t in _state_tensors(task):
        dist.broadcast(t.data, src=src, group=mesh)
    return task


def dp_impl(config: dict) -> str:
    """The config's `dp_impl`, checked: auto, gspmd and shard_map all run
    the one data-parallel step here (see the module's docstring)."""
    impl = str(config.get("dp_impl", "auto"))
    if impl not in DP_IMPLS:
        raise ValueError(f"unknown dp_impl {impl!r} (expected one of "
                         f"{', '.join(DP_IMPLS)})")
    return impl


def shard_map_step_dp(task, phase: str, mesh, *, multi_step: bool = False):
    """The task's `{phase}_step` (or, with `multi_step`, its K-step call
    `multi_step(phase, batches)`) averaging across `mesh`: the task's
    `dp_group` is set in place (a torch task holds its own state, so no
    copy is made, where JAX's `dataclasses.replace` made one). Each rank
    calls the step on its own rows (`shard_batch`)."""
    if phase not in ("gen", "gan"):
        raise ValueError(f"unknown phase {phase!r}")
    task.dp_group = mesh
    if multi_step:
        return functools.partial(task.multi_step, phase)
    return getattr(task, f"{phase}_step")


def _task_phase(step_fn):
    task = step_fn.__self__
    return task, step_fn.__name__.removesuffix("_step")


def jit_train_step_dp(step_fn, mesh):
    """`step_fn` (a task's bound `gen_step` or `gan_step`) averaging across
    `mesh`: the same step as `shard_map_step_dp`."""
    task, phase = _task_phase(step_fn)
    return shard_map_step_dp(task, phase, mesh)


def jit_multi_step_dp(step_fn, mesh):
    """The K-step call of `step_fn`'s phase averaging across `mesh` at
    every step (stacked local rows in, (K,) metrics out)."""
    task, phase = _task_phase(step_fn)
    return shard_map_step_dp(task, phase, mesh, multi_step=True)


def shard_map_forward_dp(forward_fn, mesh):
    """Data-parallel inference: `forward_fn(*batch_args)` on this rank's
    rows of each (global) batch argument, the ranks' outputs gathered back
    in rank order, so every rank returns the whole batch's output (None
    arguments pass through)."""

    def run(*args):
        out = forward_fn(*(_rows(a, mesh, 0) for a in args)).contiguous()
        if mesh is None:
            return out
        parts = [torch.empty_like(out) for _ in range(mesh_size(mesh))]
        dist.all_gather(parts, out, group=mesh)
        return torch.cat(parts)

    return run


# -- collectives inside a step ---------------------------------------------


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def psum(t, group):
    """The sum of `t` over the group's ranks, with autograd: its gradient
    is the all-reduce of the ranks' cotangents, as JAX's psum transposes
    to psum. Identity without a group."""
    if group is None:
        return t
    return _AllReduceSum.apply(t, group)


@torch.no_grad()
def pmean(tensors, group) -> list:
    """The mean of each tensor over the group's ranks, through one flat
    buffer and one all-reduce (no autograd). Identity without a group.

    Each mean comes back with its tensor's dtype and strides: a reduction
    over a tensor (the optimizer's clipping norm) sums in memory order, so
    a gradient that autograd made non-contiguous must stay so for the step
    to give one process's bits on one rank."""
    tensors = list(tensors)
    if group is None:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat.div_(mesh_size(group))
    out, i = [], 0
    for t in tensors:
        out.append(torch.empty_like(t).copy_(
            flat[i:i + t.numel()].view(t.shape)))
        i += t.numel()
    return out


def pmean_metrics(metrics: dict, group) -> dict:
    """A step's 0-d metrics, averaged over the group in one all-reduce."""
    if group is None:
        return metrics
    return dict(zip(metrics, pmean(metrics.values(), group)))


def host_group(mesh):
    """A gloo group over `mesh`'s ranks for host-side agreement (flags,
    barriers, evaluation sums on CPU tensors) that need not wait on the
    device: `mesh` itself when it is gloo already."""
    if mesh is None or dist.get_backend(mesh) == "gloo":
        return mesh
    ranks = [dist.get_global_rank(mesh, i) for i in range(mesh_size(mesh))]
    return dist.new_group(ranks, backend="gloo")
