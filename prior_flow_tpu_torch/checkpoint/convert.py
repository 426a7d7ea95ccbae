"""Weights into and out of the port (counterpart of
``prior_flow_tpu/checkpoint/convert.py``): JAX variables or reference
``.pth`` files to a state dict in the reference layout, the FlyingThings
graft of upstream-RAFT weights, the reference ``.pth`` writer, and a
seeded initialisation for hosts without weights.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..nn.layers import FrozenBatchNorm, GroupNorm


def strip_module_prefix(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Drop the DataParallel ``module.`` prefix."""
    return {(k[7:] if k.startswith("module.") else k): v
            for k, v in state_dict.items()}


def _torch_name(path) -> str:
    mods = []
    for m in path:
        if m.startswith(("layer1_", "layer2_", "layer3_")):
            mods += m.rsplit("_", 1)
        elif m.startswith("mask_"):
            mods += ["mask", m.split("_", 1)[1]]
        elif m == "downsample_0":
            mods += ["downsample", "0"]
        else:
            mods.append(m)
    return ".".join(mods)


def state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax variables (nested dicts of arrays: ``params`` plus optional
    ``batch_stats``) -> reference-layout state dict of f32 torch tensors.

    Conv kernels HWIO -> OIHW, ``scale`` -> ``weight``, ``mean``/``var`` ->
    ``running_mean``/``running_var``, ``layer1_0`` -> ``layer1.0``,
    ``mask_0`` -> ``mask.0`` (GroupNorm's ``scale`` too -> ``weight``),
    and each strided block's downsample norm re-emitted as its
    ``downsample.1`` alias (``convert.py:217-270``): a ``ResidualBlock``'s
    ``norm3``, a ``BottleneckBlock``'s ``norm4`` (upstream
    ``extractor.py``'s registration).
    """
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, path, coll):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, path + (k,), coll)
                continue
            arr = np.asarray(v, dtype=np.float32)
            if coll == "batch_stats":
                leaf = {"mean": "running_mean", "var": "running_var"}[k]
            elif k == "kernel":
                leaf = "weight"
                arr = np.transpose(arr, (3, 2, 0, 1))
            elif k == "scale":
                leaf = "weight"
            elif k == "bias":
                leaf = "bias"
            else:
                raise KeyError(f"unexpected leaf {'/'.join(path + (k,))}")
            name = _torch_name(path)
            key = f"{name}.{leaf}" if name else leaf
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))

    walk(variables.get("params", {}), (), "params")
    walk(variables.get("batch_stats", {}), (), "batch_stats")
    for key in [k for k in out if ".downsample.0." in k
                or k.startswith("downsample.0.")]:
        block = key.split("downsample.0.")[0]
        norm = ("norm4." if any(k.startswith(f"{block}norm4.") for k in out)
                else "norm3.")
        for k2 in [k for k in out if k.startswith(block + norm)]:
            out[k2.replace(norm, "downsample.1.", 1)] = out[k2]
    return out


# what the port's readers say of an Orbax directory (the JAX package's
# format, which needs JAX to read)
ORBAX_HINT = ("convert an Orbax checkpoint of the JAX package first, where "
              "JAX is installed: python convert_orbax.py CKPT_DIR OUT.pth")


def load_pth(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference checkpoint: unwrap ``state_dict``, strip
    ``module.`` and drop BatchNorm's ``num_batches_tracked`` counters,
    which the frozen norms do not hold (``convert.py:61-62,273-280``)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, Mapping) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v for k, v in strip_module_prefix(sd).items()
            if not k.endswith(".num_batches_tracked")}


def write_pth(state_dict: Mapping[str, torch.Tensor], path: str) -> str:
    """Write ``state_dict`` as a reference checkpoint: CPU tensors under
    ``module.``-prefixed names, as the reference's DataParallel model saves
    them (``convert.py:217-270``'s layout). ``load_pth`` and the CLIs'
    ``--model`` read it back."""
    torch.save({f"module.{k}": v.detach().cpu()
                for k, v in strip_module_prefix(state_dict).items()}, path)
    return path


# the ODDC blocks that the graft seeds from upstream RAFT's update_block
_GRAFT_FROM_UPDATE = ("gru", "flow_head", "mask")


def convert_things_ckpt(state_dict: Mapping[str, Any],
                        template: Mapping[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """The FlyingThings graft (``convert.py:179-215``): ``template`` (the
    model's own state dict) with every tensor of ``state_dict`` whose name
    and shape match copied in, and ``ODDC.{gru,flow_head,mask}`` seeded
    from ``update_block``'s tensors of the same shape. Each strided
    block's ``downsample.1`` alias takes its ``norm3`` value, the one
    tensor both names hold."""
    sd = strip_module_prefix(state_dict)
    out = {}
    for name, t in template.items():
        key = name.replace("downsample.1.", "norm3.")
        src = sd.get(key)
        parts = key.split(".")
        if (src is None or tuple(src.shape) != tuple(t.shape)) and (
                parts[0] == "ODDC" and parts[1] in _GRAFT_FROM_UPDATE):
            src = sd.get(".".join(["update_block"] + parts[1:]))
        if src is not None and tuple(src.shape) == tuple(t.shape):
            out[name] = torch.as_tensor(np.asarray(src)).to(t.dtype)
        else:
            out[name] = t.detach().clone()
    return out


def init_weights(model: torch.nn.Module, seed: int = 0) -> None:
    """Deterministic random weights from a CPU ``torch.Generator``: conv
    kernels truncated-normal with std 1/sqrt(fan_in) (Flax's lecun_normal),
    conv biases zero, every norm's affine (BatchNorm, GroupNorm) the
    identity (Flax's ``scale`` ones, ``bias`` zeros) and BatchNorm's
    statistics at identity. The same seed gives the same weights on every
    device."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.Conv2d):
                fan_in = mod.weight[0].numel()
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                w = torch.empty(mod.weight.shape)
                torch.nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                            generator=gen)
                mod.weight.copy_(w)
                mod.bias.zero_()
            elif isinstance(mod, (FrozenBatchNorm, GroupNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                if isinstance(mod, FrozenBatchNorm):
                    mod.running_mean.zero_()
                    mod.running_var.fill_(1.0)
