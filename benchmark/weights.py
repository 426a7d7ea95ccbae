"""Seeded weights in the reference layout, made on the device.

Convolution kernels are normal with std 1/sqrt(fan_in), clipped at two
standard deviations (LeCun normal), convolution biases normal with std
0.01, and every frozen BatchNorm an affine map near the identity (scale
1 + 0.1 n, shift 0.1 n, running mean 0.1 n, running variance 1 + 0.1 |n|),
so that the reference checks the norms' formula and not only the identity.
All of it comes from one generator on the device in one draw. A name
``X.downsample.1.K`` is the same tensor as ``X.norm3.K``, as in the
reference layout, and gets the same values.
"""

from __future__ import annotations

import math

import torch

# a draw beside a kernel's: the bias, the four BatchNorm tensors
_BN = {"weight": lambda n: 1.0 + 0.1 * n, "bias": lambda n: 0.1 * n,
       "running_mean": lambda n: 0.1 * n, "running_var": lambda n: 1.0 + 0.1 * n.abs()}


def seeded_state_dict(spec, seed: int, device) -> dict:
    """``spec``: [(name, shape)] (a reference's ``param_spec``) -> a state
    dict of f32 tensors on ``device``, a function of ``seed`` alone."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    sizes = [math.prod(shape) for _, shape in spec]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, shapes = {}, dict(spec)
    for (name, shape), n in zip(spec, torch.split(flat, sizes)):
        n = n.view(shape)
        if ".downsample.1." in name:
            out[name] = out[name.replace(".downsample.1.", ".norm3.")]
            continue
        leaf = name.rsplit(".", 1)[1]
        if leaf == "weight" and len(shape) == 4:
            std = 1.0 / math.sqrt(math.prod(shape[1:]))
            out[name] = (n.clamp(-2.0, 2.0) * std).contiguous()
        elif leaf == "bias" and (name[:-4] + "weight") in shapes \
                and len(shapes[name[:-4] + "weight"]) == 4:
            out[name] = (0.01 * n).contiguous()
        else:
            out[name] = _BN[leaf](n).contiguous()
    return out
