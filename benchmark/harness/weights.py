"""The cell's weights, made from the seed on the device in a few calls.

Every linear layer's weight and bias are U(±1/√fan_in), torch.nn.Linear's
initialisation (the task heads' output layers too, so that the logits
depend on the trunk); every norm's γ is 1 and β is 0.  One uniform draw
from a generator on the device covers all parameters; the bounds and the
constants are laid out beside it from the reference's parameter list.
The program and the reference get the same tensors by name.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from reference.model import param_specs


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    specs = param_specs(cfg)
    fan_in = {name.rsplit(".", 1)[0]: shape[1] for name, shape in specs if len(shape) == 2}
    bounds, consts, sizes = [], [], []
    for name, shape in specs:
        module, leaf = name.rsplit(".", 1)
        sizes.append(math.prod(shape))
        if leaf in ("gamma", "beta"):
            bounds.append(0.0)
            consts.append(1.0 if leaf == "gamma" else 0.0)
        else:
            bounds.append(1.0 / math.sqrt(fan_in[module]))
            consts.append(0.0)
    gen = torch.Generator(device=device).manual_seed(seed)
    counts = torch.tensor(sizes, device=device)
    total = sum(sizes)
    u = torch.rand(total, generator=gen, device=device)
    bound = torch.repeat_interleave(torch.tensor(bounds, device=device), counts, output_size=total)
    const = torch.repeat_interleave(torch.tensor(consts, device=device), counts, output_size=total)
    flat = (2.0 * u - 1.0) * bound + const
    return {name: t.view(shape) for (name, shape), t in zip(specs, flat.split(sizes))}
