"""The initial weights of a cell, drawn on the device from the seed.

Every linear layer as PyTorch's ``nn.Linear`` draws it by default, the
initialisation of the reference implementation: weight and bias uniform on
``+-1/sqrt(fan_in)``. One draw a model from a ``torch.Generator`` on the
model's device, then one scaled copy a parameter.
"""

from __future__ import annotations

import math

import torch


def fan_ins(module: torch.nn.Module) -> dict[str, int]:
    """Each parameter's fan-in: a 2-D weight's inputs, a bias its layer's."""
    names = dict(module.named_parameters())
    out = {}
    for name, p in names.items():
        if p.dim() == 2:
            out[name] = p.shape[1]
    for name, p in names.items():
        if p.dim() == 1:
            weight = name.rsplit(".", 1)[0] + ".weight"
            if weight not in out:
                raise ValueError(f"{name}: no weight beside it to take a fan-in from")
            out[name] = out[weight]
    return out


def draw_into(module: torch.nn.Module, generator: torch.Generator,
              scales: dict | None = None) -> dict[str, torch.Tensor]:
    """Overwrite ``module``'s parameters with the default initialisation drawn
    from ``generator``, the parameters under a prefix of ``scales`` (layer
    name to factor) scaled by its factor; returns a copy of them on the host,
    by name."""
    scales = scales or {}
    fans = fan_ins(module)
    params = list(module.named_parameters())
    dev = params[0][1].device
    total = sum(p.numel() for _, p in params)
    flat = torch.empty(total, device=dev).uniform_(-1.0, 1.0, generator=generator)
    off = 0
    with torch.no_grad():
        for name, p in params:
            factor = math.prod(f for pre, f in scales.items() if name.startswith(pre + "."))
            p.copy_(flat[off:off + p.numel()].view_as(p) * (factor / math.sqrt(fans[name])))
            off += p.numel()
    return {name: p.detach().to("cpu", copy=True) for name, p in params}


def generator_for(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % 2**63)
