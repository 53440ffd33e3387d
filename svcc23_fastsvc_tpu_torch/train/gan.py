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

bf16 follows the JAX package's `_cast` contract, not `torch.autocast`:
parameters and optimizer state stay f32, the step casts the parameters
(inside the graph, so gradients come back in f32) and the f32 inputs to
`compute_dtype`, and the losses are computed in f32 from outputs cast up.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch
from torch import nn

from ..data.wire import unpack_batch
from ..losses import (
    MultiResolutionSTFTLoss,
    discriminator_adversarial_loss,
    generator_adversarial_loss,
)


def _wide(t):
    """f32 from a compute dtype; f64 stays f64 (a CPU reference in double)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


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
            fuse_film=inference)
        # the losses (the STFT log magnitude above all) stay in f32
        return _wide(out)

    def _gen_loss(self, batch, sine, *, with_adv: bool):
        y_hat = self._forward(batch, sine)
        sc, mag = self.stft_loss(y_hat[..., 0], batch["audio"][..., 0])
        gen_loss = sc + mag
        metrics = {"spectral_convergence_loss": sc,
                   "log_stft_magnitude_loss": mag}
        if with_adv:
            p_hat = [[_wide(t) for t in o] for o in
                     self._apply(self.discriminator, self._cast(y_hat))]
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
        p = [[_wide(t[:B]) for t in o] for o in p_both]
        p_hat = [[_wide(t[B:]) for t in o] for o in p_both]
        real, fake = discriminator_adversarial_loss(p_hat, p)
        return real + fake, {"real_loss": real, "fake_loss": fake,
                             "discriminator_loss": real + fake}

    @staticmethod
    def _update(module, opt, loss):
        params = list(module.parameters())
        opt.step(torch.autograd.grad(loss, params))

    @staticmethod
    def _detach(metrics):
        return {k: v.detach() for k, v in metrics.items()}

    # -- steps -----------------------------------------------------------

    def gen_step(self, batch) -> dict:
        """Phase A: a generator-only update."""
        batch = self._unwire(batch)
        sine = self._sine(batch, self.rng)
        loss, metrics = self._gen_loss(batch, sine, with_adv=False)
        self._update(self.generator, self.g_opt, loss)
        self.step += 1
        return self._detach(metrics)

    def gan_step(self, batch) -> dict:
        """Phase B: a generator update with the adversarial term, then a
        discriminator update on y_ made again by the updated generator."""
        batch = self._unwire(batch)
        sine = self._sine(batch, self.rng)
        loss, metrics = self._gen_loss(batch, sine, with_adv=True)
        self._update(self.generator, self.g_opt, loss)
        # the reference reuses the batch, its excitation included
        with torch.no_grad():
            y_hat = self._forward(batch, sine, inference=True)
        d_loss, d_metrics = self._dis_loss(batch["audio"], y_hat)
        self._update(self.discriminator, self.d_opt, d_loss)
        metrics.update(d_metrics)
        self.step += 1
        return self._detach(metrics)

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
