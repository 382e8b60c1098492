"""Seeded random weights for a module built with the port's zero
initialisers (the card runs at full width with random weights: no
checkpoint is downloaded)."""
from __future__ import annotations

import math

import torch


def random_init_(model: torch.nn.Module, seed: int, on_device: bool = False) -> None:
    """Draw every parameter from a CPU generator seeded with `seed`, in the
    order of `named_parameters`: matrices and conv kernels ~ N(0, 1/fan_in),
    norm scales 1 + N(0, 0.1^2), biases N(0, 0.1^2), embedding tables and
    codebooks N(0, 1). The same seed gives the same weights on any device.
    With `on_device`, the draws come from a generator on the parameters'
    device instead (on the card, milliseconds where the host takes about
    6 ns a parameter); the weights then depend on that device. An LSTM's
    bias_ih stays 0 (its draw is taken and dropped): flax's cell has one
    bias a gate, which the port keeps in bias_hh."""
    dev = next(model.parameters()).device if on_device else torch.device("cpu")
    gen = torch.Generator(device=dev).manual_seed(seed)
    zero = {f"{m}.{n}" if m else n for m, mod in model.named_modules()
            if isinstance(mod, torch.nn.LSTM)
            for n, _ in mod.named_parameters(recurse=False) if n.startswith("bias_ih")}
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            v = torch.randn(p.shape, generator=gen, device=dev)
            if name in zero:
                v.zero_()
            elif leaf == "embedding":
                pass
            elif p.dim() >= 2:
                v /= math.sqrt(p[0].numel())
            elif leaf == "weight":  # norm scales
                v = 1 + 0.1 * v
            else:
                v *= 0.1
            p.copy_(v)
