"""LSGAN and hinge adversarial losses over nested discriminator outputs.

Counterpart of `svcc23_fastsvc_tpu/losses/adversarial.py`. Outputs are a
flat list of logits (HiFiGAN) or a list of per-layer lists (MelGAN), whose
last element, the final layer's logits, is the one scored.
"""

from __future__ import annotations

import torch


def _final_logits(outputs):
    if isinstance(outputs, (list, tuple)):
        return [o[-1] if isinstance(o, (list, tuple)) else o for o in outputs]
    return [outputs]


def generator_adversarial_loss(outputs, *, loss_type: str = "mse",
                               average_by_discriminators: bool = True):
    logits = _final_logits(outputs)
    total = 0.0
    for o in logits:
        if loss_type == "mse":
            total = total + torch.mean(torch.square(o - 1.0))
        elif loss_type == "hinge":
            total = total - torch.mean(o)
        else:
            raise ValueError(loss_type)
    if average_by_discriminators:
        total = total / len(logits)
    return total


def discriminator_adversarial_loss(outputs_hat, outputs, *,
                                   loss_type: str = "mse",
                                   average_by_discriminators: bool = True):
    """Returns (real_loss, fake_loss)."""
    fake = _final_logits(outputs_hat)
    real = _final_logits(outputs)
    real_loss, fake_loss = 0.0, 0.0
    for o_hat, o in zip(fake, real):
        if loss_type == "mse":
            real_loss = real_loss + torch.mean(torch.square(o - 1.0))
            fake_loss = fake_loss + torch.mean(torch.square(o_hat))
        elif loss_type == "hinge":
            real_loss = real_loss - torch.mean(torch.clamp(o - 1.0, max=0.0))
            fake_loss = fake_loss - torch.mean(
                torch.clamp(-o_hat - 1.0, max=0.0))
        else:
            raise ValueError(loss_type)
    if average_by_discriminators:
        real_loss = real_loss / len(real)
        fake_loss = fake_loss / len(fake)
    return real_loss, fake_loss
