"""Seeded random weights for a module built with the port's zero
initialisers (the card runs at full width with random weights: no
checkpoint is downloaded)."""
from __future__ import annotations

import math

import torch


def random_init_(model: torch.nn.Module, seed: int) -> None:
    """Draw every parameter from a CPU generator seeded with `seed`, in the
    order of `named_parameters`: matrices and conv kernels ~ N(0, 1/fan_in),
    norm scales 1 + N(0, 0.1^2), biases N(0, 0.1^2), embedding tables and
    codebooks N(0, 1). The same seed gives the same weights on any device."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            v = torch.randn(p.shape, generator=gen)
            if leaf == "embedding":
                pass
            elif p.dim() >= 2:
                v /= math.sqrt(p[0].numel())
            elif leaf == "weight":  # norm scales
                v = 1 + 0.1 * v
            else:
                v *= 0.1
            p.copy_(v)
