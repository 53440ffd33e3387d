"""B02 acoustic-model train step (Tacotron2 + MultiSubFreqDiscriminator).

Counterpart of `svcc23_fastsvc_tpu/train/b02.py::B02TrainTask`. The recipe
trains in two phases split at `discriminator_train_start_steps`:

  `gen_step`  G update on the masked MSE of the teacher-forced mcep | bap;
  `gan_step`  G update on MSE + lambda_adv * adv(D(pred)), then pred made
              again by the UPDATED G in train mode (no grad) and a D update
              on the real | fake LSGAN losses over random 50-frame windows.

Two reference behaviours are kept exactly, as the JAX task keeps them:

* in the G update the discriminator's input is detached (reference
  train_b02.py:201), so the adversarial term is logged but gives G no
  gradient;
* the batch norms' running statistics advance twice in a `gan_step`: once
  in the G step and once in the train-mode forward of the updated G
  before the D update. They live in the generator's BatchNorm1d buffers,
  chain from step to step with momentum 0.1, and are written back after
  each forward (`Tacotron2.set_bn_state`); eval and decode read them.

The task holds the models, their optimizers (`train.state.RefRAdam`), the
step count and the generator of its random draws (dropout keep masks,
window starts); each step updates them in place and returns its metrics
as 0-d device tensors. A step takes its draws from an explicit `draws`
argument (see `draw`), which the tests fill with JAX's, or from that
generator.

`multi_step` runs K steps of one phase in a call, the counterpart of JAX
`make_multi_step` (a `lax.scan` there), on the pattern of
`train.gan.FastSVCTrainTask`: its body, `run_steps`, reads the
optimizers' per-step scalars from a device table and draws its masks and
window starts from the task's generator on the device, so
`train.graphs.StepGraphs` captures it as one CUDA graph.

Data parallelism (`dp_group`, as in `train.gan.FastSVCTrainTask`): each
rank runs the step on its own rows; each player's gradients and the
metrics are averaged across the group before the optimizer step, and the
two couplings across the batch stay global, as in JAX's GSPMD step: the
batch norms' statistics (`models.tacotron2.batch_norm_train`) and the
masked MSE's numerator and count are summed across the ranks before they
are divided, so uneven lengths and per-rank statistics change nothing.

bf16 follows the JAX package's `_cast`: parameters, optimizer state and
losses stay f32, the generator's parameters and the f32 inputs are cast
to `compute_dtype`, and the batch-norm statistics stay f32 (they are
buffers, not parameters). The discriminator runs in f32, on f32 inputs,
as JAX runs it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, ClassVar

import numpy as np
import torch
from torch import nn

from ..losses import (
    discriminator_adversarial_loss,
    generator_adversarial_loss,
    masked_mse_loss,
)
from ..parallel.mesh import pmean, pmean_metrics


def _wide(t):
    """f32 from a compute dtype; f64 stays f64 (a CPU reference in double)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


@dataclass
class B02TrainTask:
    generator: nn.Module  # models.tacotron2.Tacotron2
    discriminator: nn.Module  # models.tacotron2.MultiSubFreqDiscriminator
    g_opt: Any
    d_opt: Any
    lambda_l1: float = 1.0
    lambda_adv: float = 1.0
    adv_loss_type: str = "mse"
    compute_dtype: Any = None  # torch.bfloat16 for bf16 compute
    rng: Any = None  # torch.Generator of the random draws
    step: int = 0
    # the data group to average gradients and metrics over, or None
    dp_group: Any = None

    # the reference wrapper's prefix of the generator's checkpoint keys
    # (`train.checkpoint`), and the name of the draws' generator state there
    generator_prefix: ClassVar[str] = "acoustic_network."
    rng_key: ClassVar[str] = "draws"

    @property
    def device(self):
        return next(self.generator.parameters()).device

    # -- pieces ----------------------------------------------------------

    def _cast(self, x):
        if (self.compute_dtype is None or x is None
                or x.dtype != torch.float32):
            return x
        return x.to(self.compute_dtype)

    def _apply_generator(self, *args, **kwargs):
        """The generator with its f32 parameters cast to compute_dtype (its
        batch-norm buffers stay f32)."""
        if self.compute_dtype is None:
            return self.generator(*args, **kwargs)
        params = {n: self._cast(p)
                  for n, p in self.generator.named_parameters()}
        return torch.func.functional_call(self.generator, params, args,
                                          kwargs)

    def draw(self, phase: str, batch: dict, generator=None) -> dict:
        """The random draws of one step of `phase` from `generator` (the
        task's by default): "g" the generator's dropout masks
        (`Tacotron2.train_draws`), and for "gan" also "d_g" (window starts
        of the logged adversarial term), "g2" (the masks of the second,
        updated-G forward) and "d_real", "d_fake" (the D update's window
        starts). "eval" draws the prenet's masks only."""
        rng = self.rng if generator is None else generator
        B, T = batch["ppg"].shape[:2]
        dev = batch["ppg"].device

        def masks(train=True):
            return self.generator.train_draws(B, T, train=train,
                                              generator=rng, device=dev)

        def starts():
            return self.discriminator.window_starts(batch["lengths"],
                                                    generator=rng)

        if phase == "eval":
            return {"g": masks(train=False)}
        if phase == "gen":
            return {"g": masks()}
        return {"g": masks(), "d_g": starts(), "g2": masks(),
                "d_real": starts(), "d_fake": starts()}

    def _forward(self, batch, masks, *, train: bool):
        """Teacher-forced G: (pred in f32, new batch-norm statistics)."""
        pred, _, bn = self._apply_generator(
            self._cast(batch["ppg"]), batch["lengths"],
            self._cast(batch["lft"]), self._cast(batch["lf0"]),
            self._cast(batch["spk_emb"]), self._cast(batch["targets"]),
            train=train, draws=masks, group=self.dp_group)
        # the losses stay in f32; the statistics are f32 already
        return _wide(pred), bn

    def _gen_loss(self, batch, draws, *, with_adv: bool, train: bool = True):
        pred, bn = self._forward(batch, draws["g"], train=train)
        mse = masked_mse_loss(pred, batch["targets"], batch["lengths"],
                              self.dp_group)
        metrics = {"mse_loss": mse}
        gen_loss = self.lambda_l1 * mse
        if with_adv:
            # the reference detaches G's output here (train_b02.py:201):
            # the term is logged and gives G no gradient
            with torch.no_grad():
                p_hat = self.discriminator(pred.detach(), batch["lengths"],
                                           starts=draws["d_g"])
            adv = generator_adversarial_loss(p_hat,
                                             loss_type=self.adv_loss_type)
            metrics["adversarial_loss"] = adv
            gen_loss = gen_loss + self.lambda_adv * adv
        metrics["generator_loss"] = gen_loss
        return gen_loss, metrics, bn

    def _update(self, module, opt, loss, coef=None):
        grads = torch.autograd.grad(loss, list(module.parameters()))
        grads = pmean(grads, self.dp_group)
        if coef is None:
            opt.step(grads)
        else:
            opt.step(grads, coef)

    def _detach(self, metrics):
        return pmean_metrics({k: v.detach() for k, v in metrics.items()},
                             self.dp_group)

    # -- steps -----------------------------------------------------------

    def _gen(self, batch, draws, g_coef=None):
        draws = draws or self.draw("gen", batch)
        loss, metrics, bn = self._gen_loss(batch, draws, with_adv=False)
        self._update(self.generator, self.g_opt, loss, g_coef)
        self.generator.set_bn_state(bn)
        return self._detach(metrics)

    def _gan(self, batch, draws, g_coef=None, d_coef=None):
        draws = draws or self.draw("gan", batch)
        loss, metrics, bn = self._gen_loss(batch, draws, with_adv=True)
        self._update(self.generator, self.g_opt, loss, g_coef)
        self.generator.set_bn_state(bn)
        # the reference makes pred again with the UPDATED G in train mode
        # (train_b02.py:225-233), advancing the running statistics again
        with torch.no_grad():
            pred, bn = self._forward(batch, draws["g2"], train=True)
        self.generator.set_bn_state(bn)
        lengths = batch["lengths"]
        p_real = self.discriminator(batch["targets"], lengths,
                                    starts=draws["d_real"])
        p_fake = self.discriminator(pred, lengths, starts=draws["d_fake"])
        real, fake = discriminator_adversarial_loss(
            p_fake, p_real, loss_type=self.adv_loss_type)
        self._update(self.discriminator, self.d_opt, real + fake, d_coef)
        metrics.update(real_loss=real, fake_loss=fake,
                       discriminator_loss=real + fake)
        return self._detach(metrics)

    def gen_step(self, batch: dict, draws: dict = None) -> dict:
        """Phase A: a generator-only update."""
        metrics = self._gen(batch, draws)
        self.step += 1
        return metrics

    def gan_step(self, batch: dict, draws: dict = None) -> dict:
        """Phase B: a generator update with the (detached) adversarial term
        logged, then the updated G's train-mode forward (the batch norms'
        second update) and a discriminator update on it."""
        metrics = self._gan(batch, draws)
        self.step += 1
        return metrics

    # -- K steps a call ----------------------------------------------------

    def coefficient_table(self, k: int) -> np.ndarray:
        """(2, k, 4) f32: G's and D's `RefRAdam.coefficients` for the next
        k steps (D's unused by a gen call)."""
        return np.stack([self.g_opt.coefficients(k),
                         self.d_opt.coefficients(k)])

    def run_steps(self, phase: str, batches: dict, coefs, draws=None) -> dict:
        """k steps of `phase` ("gen" or "gan") on `batches` stacked on a
        leading k axis, with the optimizers' scalars from `coefs` (a device
        tensor of `coefficient_table(k)`) and each step's draws from
        `draws[i]` (a list of k `draw` dicts) or from the task's generator
        on the device. Metrics come back stacked, (k,) each. Nothing on the
        host changes and nothing waits on the device, so `train.graphs`
        captures it; `advance` counts the steps."""
        k = coefs.shape[1]
        rows = []
        for i in range(k):
            batch = {name: v[i] for name, v in batches.items()}
            d = None if draws is None else draws[i]
            if phase == "gen":
                rows.append(self._gen(batch, d, coefs[0, i]))
            else:
                rows.append(self._gan(batch, d, coefs[0, i], coefs[1, i]))
        return {name: torch.stack([r[name] for r in rows])
                for name in rows[0]}

    def advance(self, phase: str, k: int):
        """Count k steps of `phase` run by `run_steps`."""
        self.step += k
        self.g_opt.advance(k)
        if phase == "gan":
            self.d_opt.advance(k)

    def multi_step(self, phase: str, batches: dict, draws=None) -> dict:
        """k steps of `phase` in one call, eagerly: the counterpart of JAX
        `make_multi_step(task.{phase}_step)`. `batches` holds device tensors
        stacked on a leading k axis; the metrics are (k,) device tensors.
        The same bits as k calls of `{phase}_step`."""
        k = next(iter(batches.values())).shape[0]
        coefs = torch.from_numpy(self.coefficient_table(k)).to(self.device)
        metrics = self.run_steps(phase, batches, coefs, draws)
        self.advance(phase, k)
        return metrics

    @torch.no_grad()
    def eval_step(self, batch: dict) -> dict:
        """The MSE and generator loss in eval mode (the running statistics,
        no dropout but the prenet's, no adversarial term), without updates.
        The prenet's masks come from a generator of its own, so evaluation
        leaves the training stream as it was."""
        rng = torch.Generator(device=self.device).manual_seed(self.step)
        _, metrics, _ = self._gen_loss(batch, self.draw("eval", batch, rng),
                                       with_adv=False, train=False)
        return self._detach(metrics)
