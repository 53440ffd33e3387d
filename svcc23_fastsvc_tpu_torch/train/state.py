"""The optimizer of both GAN players: clipping, reference RAdam, StepLR.

Counterpart of `svcc23_fastsvc_tpu/train/state.py::make_optimizer` (an
optax chain there): global-norm gradient clipping (10 for G and 1 for D in
the recipe), the reference's RAdam (harana/optimizers/radam.py, the
LiyuanLucasLiu implementation), optional weight decay, and a staircase
StepLR schedule applied per optimizer step. Written as plain tensor code
over a parameter list; `step` takes the gradients explicitly.

The RAdam rule is the JAX package's `scale_by_ref_radam`, including the
eps placement that differs from `torch.optim.RAdam` (m / (sqrt(v) + eps),
with the sqrt(1 - b2^t) bias correction folded into the step size) and the
cancellation-free rho_t, computed in f32 in the same order as there.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def make_schedule(lr: float, step_size: int, gamma: float):
    """torch StepLR: lr * gamma^(count // step_size), count from 0."""
    def schedule(count: int) -> float:
        return float(np.float32(lr) * np.float32(gamma) ** np.float32(
            count // step_size))
    return schedule


B1, B2 = 0.9, 0.999  # the reference RAdam's betas


def radam_coefficients(t: int):
    """(use_rect, rect, sgd_step) of RAdam step t (1-based), in f32.

    rho_t = rho_inf - 2t b2^t / (1 - b2^t) cancels two terms of about
    2 / (1 - b2) in f32, so it is computed as C (1 - g(s)) - (C - rho_inf)
    with s = -t ln b2, C = -2 / ln b2, g(s) = s / expm1(s), and 1 - g(s)
    from its series for small s, as the JAX package does.
    """
    f32 = np.float32
    log_b1, log_b2 = math.log(B1), math.log(B2)
    rho_inf = 2.0 / (1.0 - B2) - 1.0
    c_coef = -2.0 / log_b2
    d_coef = c_coef - rho_inf
    tf = f32(t)
    b1t = np.exp(tf * f32(log_b1))
    s = -tf * f32(log_b2)
    em1 = np.expm1(s)
    if s < f32(0.69):
        h = s * (f32(0.5) - s * (f32(1.0 / 12.0) - s * s * (
            f32(1.0 / 720.0) - s * s / f32(30240.0))))
    else:
        h = (em1 - s) / max(em1, f32(1e-30))
    rho_t = f32(c_coef) * h - f32(d_coef)
    one_minus_b2t = -np.expm1(-s)
    inner = (one_minus_b2t * (rho_t - f32(4.0)) / f32(rho_inf - 4.0)
             * (rho_t - f32(2.0)) / rho_t * f32(rho_inf) / f32(rho_inf - 2.0))
    rect = np.sqrt(inner) / (f32(1.0) - b1t) if inner >= 0 else f32(0.0)
    sgd_step = f32(1.0) / (f32(1.0) - b1t)
    return bool(rho_t >= f32(5.0)), float(rect), float(sgd_step)


def clip_by_global_norm(grads, max_norm: float):
    """optax.clip_by_global_norm: g / ||g|| * max_norm when ||g|| >= max_norm.
    The choice is made on the device (no host sync)."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads]


class RefRAdam:
    """The JAX package's `make_optimizer` chain over a list of parameters.

    Per step: clip (if grad_norm > 0) -> RAdam -> + weight_decay * p ->
    * -lr(count) -> p += update. `state_dict` follows torch's optimizer and
    StepLR layouts, as the reference trainer checkpoints them.
    """

    def __init__(self, params, *, lr: float = 1e-3, eps: float = 1e-6,
                 weight_decay: float = 0.0, grad_norm: float = 0.0,
                 scheduler_step_size: int = 100000,
                 scheduler_gamma: float = 0.5):
        self.params = list(params)
        self.lr, self.eps, self.weight_decay = lr, eps, weight_decay
        self.grad_norm = grad_norm
        self.step_size, self.gamma = scheduler_step_size, scheduler_gamma
        self.schedule = make_schedule(lr, scheduler_step_size,
                                      scheduler_gamma)
        self.count = 0
        # made at the first step (or load), like the parameters then are
        self.mu = self.nu = None

    def _init_state(self):
        if self.mu is None:
            self.mu = [torch.zeros_like(p) for p in self.params]
            self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads):
        """Update the parameters in place from their gradients."""
        self._init_state()
        grads = [g.to(p.dtype) for g, p in zip(grads, self.params)]
        if self.grad_norm and self.grad_norm > 0:
            grads = clip_by_global_norm(grads, self.grad_norm)
        lr = self.schedule(self.count)
        self.count += 1
        use_rect, rect, sgd_step = radam_coefficients(self.count)
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(B1).add_(g * (1.0 - B1))
            v.mul_(B2).add_(g * g * (1.0 - B2))
            if use_rect:
                u = rect * m / (torch.sqrt(v) + self.eps)
            else:
                u = sgd_step * m
            if self.weight_decay:
                u = u + self.weight_decay * p
            p.add_(u * -lr)

    def current_lr(self) -> float:
        return self.schedule(self.count)

    def state_dict(self) -> dict:
        self._init_state()
        optimizer = {
            "state": {i: {"step": self.count, "exp_avg": m.detach().cpu(),
                          "exp_avg_sq": v.detach().cpu()}
                      for i, (m, v) in enumerate(zip(self.mu, self.nu))},
            "param_groups": [{
                "lr": self.current_lr(), "betas": (B1, B2),
                "eps": self.eps, "weight_decay": self.weight_decay,
                "params": list(range(len(self.params))),
            }],
        }
        scheduler = {"step_size": self.step_size, "gamma": self.gamma,
                     "base_lrs": [self.lr], "last_epoch": self.count,
                     "_last_lr": [self.current_lr()]}
        return {"optimizer": optimizer, "scheduler": scheduler}

    def load_state_dict(self, optimizer: dict, scheduler: dict):
        state = optimizer["state"]
        if len(state) != len(self.params):
            raise ValueError(f"optimizer state for {len(state)} tensors, "
                             f"{len(self.params)} parameters")
        self._init_state()
        for i, (m, v) in enumerate(zip(self.mu, self.nu)):
            m.copy_(state[i]["exp_avg"])
            v.copy_(state[i]["exp_avg_sq"])
        self.count = int(scheduler["last_epoch"])
        counts = {int(s["step"]) for s in state.values()}
        if counts and counts != {self.count}:
            raise ValueError(f"optimizer steps {counts} != scheduler "
                             f"{self.count}")

