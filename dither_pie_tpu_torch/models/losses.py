"""The GAN objectives of the trainer, as the JAX package's
``models/losses.py`` computes them: plain functions of (prediction,
target_is_real)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

GAN_MODES = ("lsgan", "vanilla", "wgangp")


def gan_loss(prediction: torch.Tensor, target_is_real: bool, gan_mode: str = "lsgan",
             target_real_label: float = 1.0, target_fake_label: float = 0.0) -> torch.Tensor:
    """Scalar GAN loss.

    lsgan   -> MSE against the label
    vanilla -> BCE-with-logits against the label,
               mean(max(x, 0) - x t + log1p(exp(-|x|)))
    wgangp  -> -mean(pred) for real, +mean(pred) for fake (no gradient
               penalty, as in the JAX package)
    """
    pred = prediction.float()
    if gan_mode == "wgangp":
        return -pred.mean() if target_is_real else pred.mean()
    target = target_real_label if target_is_real else target_fake_label
    if gan_mode == "lsgan":
        return ((pred - target) ** 2).mean()
    if gan_mode == "vanilla":
        return (F.relu(pred) - pred * target + torch.log1p(torch.exp(-pred.abs()))).mean()
    raise NotImplementedError(f"gan mode {gan_mode} not implemented")
