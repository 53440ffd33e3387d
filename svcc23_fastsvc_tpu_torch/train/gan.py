"""FastSVC GAN train step, in two phases.

Counterpart of `svcc23_fastsvc_tpu/train/gan.py::FastSVCTrainTask`. The
recipe trains in two phases split at `discriminator_train_start_steps`:

  `gen_step`  G update on the multi-resolution STFT loss only;
  `gan_step`  G update on STFT + lambda_adv * adv(D(y_)), then y_ made
              again by the UPDATED G (no grad, fused-FiLM forward, the same
              excitation) and a D update on the real|fake LSGAN losses.

The task holds the models, their optimizers (`train.state.RefRAdam`), the
step count and the excitation's noise generator; each step updates them in
place and returns its metrics as 0-d device tensors (no host sync).

`multi_step` runs K steps of one phase in a call, the counterpart of JAX
`make_multi_step` (a `lax.scan` there): batches stacked on a leading K
axis in, metrics (K,) out. Its body, `run_steps`, reads every per-step
scalar of the optimizers from a device table and changes nothing on the
host, so `train.graphs` can capture it as one CUDA graph; on the CPU it is
an eager loop over the same per-step code.

Data parallelism (`dp_group`, the counterpart of JAX's `pmean_axis`;
`parallel.mesh`): each rank runs the step on its own rows; the gradients
of each player are averaged across the group in one flat all-reduce
before its optimizer step (so RAdam's clipping sees the global
gradient), the metrics in one more, and the STFT loss's spectral
convergence sums its norms across the group. The ranks' excitation noise
comes from their own generators (`Trainer` seeds rank r's with seed +
r). On the card a K-step call captures those all-reduces in its graph,
which NCCL allows (`train.graphs`).

bf16 follows the JAX package's `_cast` contract, not `torch.autocast`:
parameters and optimizer state stay f32, the step casts the parameters
(inside the graph, so gradients come back in f32) and the f32 inputs to
`compute_dtype`, and the losses are computed in f32 from outputs cast up.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, ClassVar

import numpy as np
import torch
from torch import nn

from ..data.wire import unpack_batch
from ..losses import (
    MultiResolutionSTFTLoss,
    discriminator_adversarial_loss,
    generator_adversarial_loss,
)
from ..parallel.mesh import pmean, pmean_metrics


def _wide(t):
    """f32 from a compute dtype; f64 stays f64 (a CPU reference in double)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _tree(fn, outs):
    """`fn` on every tensor of a discriminator's output: MelGAN's list of
    per-scale lists, HiFiGAN's flat list of logits."""
    if isinstance(outs, torch.Tensor):
        return fn(outs)
    return [_tree(fn, o) for o in outs]


@dataclass
class FastSVCTrainTask:
    generator: nn.Module
    discriminator: nn.Module
    g_opt: Any
    d_opt: Any
    signal_generator: Any
    stft_loss: MultiResolutionSTFTLoss = field(
        default_factory=MultiResolutionSTFTLoss)
    lambda_adv: float = 2.5
    compute_dtype: Any = None  # torch.bfloat16 for bf16 compute
    rng: Any = None  # torch.Generator of the excitation noise
    step: int = 0
    # the data group to average gradients and metrics over, or None
    dp_group: Any = None

    # the generator's checkpoint keys carry no prefix (`train.checkpoint`);
    # the noise generator's state is stored under "sine"
    generator_prefix: ClassVar[str] = ""
    rng_key: ClassVar[str] = "sine"

    @property
    def device(self):
        return next(self.generator.parameters()).device

    # -- pieces ----------------------------------------------------------

    def _cast(self, x):
        if (self.compute_dtype is None or x is None
                or x.dtype != torch.float32):
            return x
        return x.to(self.compute_dtype)

    def _apply(self, module, *args, **kwargs):
        """module(*args) with its f32 parameters cast to compute_dtype."""
        if self.compute_dtype is None:
            return module(*args, **kwargs)
        params = {n: self._cast(p) for n, p in module.named_parameters()}
        return torch.func.functional_call(module, params, args, kwargs)

    def _unwire(self, batch):
        """Invert the host-to-device wire format (data/wire.py); an f32
        batch passes unchanged."""
        return unpack_batch(batch, hop_size=self.signal_generator.hop_size)

    def _sine(self, batch, rng):
        """A precomputed batch["sine"] takes precedence over the excitation
        made here from batch["f0"] (the parity tests feed one in)."""
        sine = batch.get("sine")
        if sine is None:
            sine = self.signal_generator(batch["f0"], rng)
        return sine

    def _forward(self, batch, sine, *, inference: bool = False):
        """G's output in f32; `inference` (no gradient) fuses the FiLM
        output convs."""
        out = self._apply(
            self.generator, self._cast(batch["ppg"]), self._cast(sine),
            self._cast(batch["lft"]), self._cast(batch.get("spk_emb")),
            fuse_film=inference, f32_out=True)
        # the losses (the STFT log magnitude above all) stay in f32
        return _wide(out)

    def _gen_loss(self, batch, sine, *, with_adv: bool):
        y_hat = self._forward(batch, sine)
        sc, mag = self.stft_loss(y_hat[..., 0], batch["audio"][..., 0],
                                 self.dp_group)
        gen_loss = sc + mag
        metrics = {"spectral_convergence_loss": sc,
                   "log_stft_magnitude_loss": mag}
        if with_adv:
            p_hat = _tree(_wide, self._apply(self.discriminator,
                                             self._cast(y_hat)))
            adv = generator_adversarial_loss(p_hat)
            metrics["adversarial_loss"] = adv
            gen_loss = gen_loss + self.lambda_adv * adv
        metrics["generator_loss"] = gen_loss
        return gen_loss, metrics

    def _dis_loss(self, y, y_hat):
        # one 2B pass over real|fake: the discriminator is batch-independent
        B = y.shape[0]
        both = torch.cat([self._cast(y), self._cast(y_hat)], dim=0)
        p_both = self._apply(self.discriminator, both)
        p = _tree(lambda t: _wide(t[:B]), p_both)
        p_hat = _tree(lambda t: _wide(t[B:]), p_both)
        real, fake = discriminator_adversarial_loss(p_hat, p)
        return real + fake, {"real_loss": real, "fake_loss": fake,
                             "discriminator_loss": real + fake}

    def _update(self, module, opt, loss, coef=None):
        grads = torch.autograd.grad(loss, list(module.parameters()))
        grads = pmean(grads, self.dp_group)
        if coef is None:  # the host path: wrappers of opt.step(grads) work
            opt.step(grads)
        else:
            opt.step(grads, coef)

    def _detach(self, metrics):
        return pmean_metrics({k: v.detach() for k, v in metrics.items()},
                             self.dp_group)

    # -- steps -----------------------------------------------------------

    def _gen(self, batch, g_coef=None):
        batch = self._unwire(batch)
        sine = self._sine(batch, self.rng)
        loss, metrics = self._gen_loss(batch, sine, with_adv=False)
        self._update(self.generator, self.g_opt, loss, g_coef)
        return self._detach(metrics)

    def _gan(self, batch, g_coef=None, d_coef=None):
        batch = self._unwire(batch)
        sine = self._sine(batch, self.rng)
        loss, metrics = self._gen_loss(batch, sine, with_adv=True)
        self._update(self.generator, self.g_opt, loss, g_coef)
        # the reference reuses the batch, its excitation included
        with torch.no_grad():
            y_hat = self._forward(batch, sine, inference=True)
        d_loss, d_metrics = self._dis_loss(batch["audio"], y_hat)
        self._update(self.discriminator, self.d_opt, d_loss, d_coef)
        metrics.update(d_metrics)
        return self._detach(metrics)

    def gen_step(self, batch) -> dict:
        """Phase A: a generator-only update."""
        metrics = self._gen(batch)
        self.step += 1
        return metrics

    def gan_step(self, batch) -> dict:
        """Phase B: a generator update with the adversarial term, then a
        discriminator update on y_ made again by the updated generator."""
        metrics = self._gan(batch)
        self.step += 1
        return metrics

    # -- K steps a call ----------------------------------------------------

    def coefficient_table(self, k: int) -> np.ndarray:
        """(2, k, 4) f32: G's and D's `RefRAdam.coefficients` for the next
        k steps (D's unused by a gen call)."""
        return np.stack([self.g_opt.coefficients(k),
                         self.d_opt.coefficients(k)])

    def run_steps(self, phase: str, batches: dict, coefs) -> dict:
        """k steps of `phase` ("gen" or "gan") on `batches` stacked on a
        leading k axis, with the optimizers' scalars from `coefs` (a device
        tensor of `coefficient_table(k)`). Metrics come back stacked, (k,)
        each. Nothing on the host changes: `advance` counts the steps."""
        k = coefs.shape[1]
        rows = []
        for i in range(k):
            batch = {name: v[i] for name, v in batches.items()}
            if phase == "gen":
                rows.append(self._gen(batch, coefs[0, i]))
            else:
                rows.append(self._gan(batch, coefs[0, i], coefs[1, i]))
        return {name: torch.stack([r[name] for r in rows])
                for name in rows[0]}

    def advance(self, phase: str, k: int):
        """Count k steps of `phase` run by `run_steps`."""
        self.step += k
        self.g_opt.advance(k)
        if phase == "gan":
            self.d_opt.advance(k)

    def multi_step(self, phase: str, batches: dict) -> dict:
        """k steps of `phase` in one call, eagerly: the counterpart of JAX
        `make_multi_step(task.{phase}_step)`. `batches` holds device tensors
        stacked on a leading k axis; the metrics are (k,) device tensors.
        The same bits as k calls of `{phase}_step`."""
        k = next(iter(batches.values())).shape[0]
        coefs = torch.from_numpy(self.coefficient_table(k)).to(self.device)
        metrics = self.run_steps(phase, batches, coefs)
        self.advance(phase, k)
        return metrics

    @torch.no_grad()
    def predict(self, batch, *, seed: int):
        """G's output (B, T, 1) in f32 for a batch of device tensors, eager
        and in the compute dtype, the excitation noise from a generator
        seeded by `seed` (the trainer's intermediate dumps)."""
        batch = self._unwire(batch)
        rng = torch.Generator(device=self.device).manual_seed(seed)
        return self._forward(batch, self._sine(batch, rng))

    @torch.no_grad()
    def eval_step(self, batch, *, with_adv: bool = True) -> dict:
        """Losses without updates. The excitation noise comes from a
        generator of its own, so evaluation leaves the training stream as
        it was."""
        batch = self._unwire(batch)
        rng = torch.Generator(device=self.device).manual_seed(self.step)
        sine = self._sine(batch, rng)
        _, metrics = self._gen_loss(batch, sine, with_adv=with_adv)
        if with_adv:
            y_hat = self._forward(batch, sine)
            metrics.update(self._dis_loss(batch["audio"], y_hat)[1])
        return self._detach(metrics)
