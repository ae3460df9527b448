"""The policy's initial weights, made by the benchmark on the device from
the seed in one draw and handed alike to the program and the reference:
per dense layer N(0, gain^2 / fan_in) with the port's gains (sqrt 2 on
hidden layers, 1 on a network's output layer), zero biases, the action
std at the configuration's ``init_noise_std``."""
from __future__ import annotations

import math

import torch


def make(model, seed, init_noise_std, device):
    """{name: tensor} for every entry of ``model.state_dict()``."""
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    weights = [k for k, s in shapes.items() if len(s) == 2]
    # the last dense layer of each network (actor, critic) is its output
    last = {}
    for k in weights:
        last[k.split(".")[0]] = k
    total = sum(math.prod(shapes[k]) for k in weights)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for k, shape in shapes.items():
        if k in weights:
            n = math.prod(shape)
            gain = 1.0 if k in last.values() else math.sqrt(2.0)
            out[k] = flat[at: at + n].view(shape) * (gain
                                                     / math.sqrt(shape[1]))
            at += n
        elif k == "std":
            out[k] = torch.full(shape, float(init_noise_std), device=device)
        else:
            out[k] = torch.zeros(shape, device=device)
    return out

