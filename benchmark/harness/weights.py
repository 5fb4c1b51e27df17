"""The cell's weights, made from the seed on the device in a few calls.

Every linear layer's weight and bias are U(±1/√fan_in), torch.nn.Linear's
initialisation (the task heads' output layers too, so that the logits
depend on the trunk); every norm's γ is 1 and β is 0.  A leaf of neither
kind (one of a module without a 2-D weight, such as an attention vector)
is placed by the reference module's ``weight_rule(name, shape, fan_in)``,
which returns its (bound, constant): the leaf is U(±bound) + constant;
``fan_in`` maps each module with a 2-D weight to its fan-in.  One uniform
draw from a generator on the device covers all parameters; the bounds
and the constants are laid out beside it from the reference's parameter
list.  The program and the reference get the same tensors by name.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def make_weights(cfg: dict, seed: int, device, reference) -> Dict[str, torch.Tensor]:
    """The weights of ``reference.param_specs(cfg)`` from ``seed``."""
    specs = reference.param_specs(cfg)
    rule = getattr(reference, "weight_rule", None)
    fan_in = {name.rsplit(".", 1)[0]: shape[1] for name, shape in specs if len(shape) == 2}
    bounds, consts, sizes = [], [], []
    for name, shape in specs:
        module, leaf = name.rsplit(".", 1)
        sizes.append(math.prod(shape))
        if leaf in ("gamma", "beta"):
            bound, const = 0.0, (1.0 if leaf == "gamma" else 0.0)
        elif module in fan_in:
            bound, const = 1.0 / math.sqrt(fan_in[module]), 0.0
        elif rule is not None:
            bound, const = rule(name, tuple(shape), fan_in)
        else:
            raise KeyError(f"no rule places the leaf {name!r} {tuple(shape)}: it is neither a "
                           "norm's nor a Linear's, and the reference has no weight_rule")
        bounds.append(bound)
        consts.append(const)
    gen = torch.Generator(device=device).manual_seed(seed)
    counts = torch.tensor(sizes, device=device)
    total = sum(sizes)
    u = torch.rand(total, generator=gen, device=device)
    bound = torch.repeat_interleave(torch.tensor(bounds, device=device), counts, output_size=total)
    const = torch.repeat_interleave(torch.tensor(consts, device=device), counts, output_size=total)
    flat = (2.0 * u - 1.0) * bound + const
    return {name: t.view(shape) for (name, shape), t in zip(specs, flat.split(sizes))}
