"""Serving and export: the inference forward as an AOTInductor package and
as a portable ``torch.export`` program (counterpart of
``prior_flow_tpu/serving/export.py``).

Two artifacts, as in the JAX package:

1. **AOT-compiled package** (``aot_compile``): AOTInductor compiles the
   forward ahead of time into a ``.pt2`` package, so a serving process
   pays no tracing or compilation at request time. The hand-written
   kernels run in it as the ``priorflow::`` ops
   (``ops/kernels/library.py``), called back through AOTInductor's proxy
   executor.
2. **Exported program** (``export_forward`` / ``save_exported`` /
   ``load_exported``): the ``torch.export`` graph with its input and
   output specs in a ``.pt2`` file. ``load_exported`` needs the op
   registrations (``prior_flow_tpu_torch.ops.kernels``) and not the model
   code.

Weights are inputs of both, passed at call time as a state dict (a
model's ``state_dict()`` or ``checkpoint.load_pth``'s, on the artifact's
device), as the JAX package passes ``variables``: neither artifact holds
weights that could go stale.

Inference config matches the JAX package's: test-mode forward, ``iters``
GRU iterations, inputs (B, H, W, 3) f32 in [0, 255], output the final
upsampled branch-A flow (B, H, W, 2).

Portability:

- An artifact is bound to the device type it was exported on, the card
  unless ``device="cpu"`` is given. JAX's multi-platform artifacts need its
  pure-XLA lookup (``lookup_mode='mxu'``), which the port does not have
  (ROADMAP Queue 1, item 11), so ``platforms`` other than the export
  device raise.
- Shapes are static: one artifact per (batch, H, W, iters). AOTInductor
  does not refuse an input of another shape (it resizes its output), so
  the package's callable checks every input against the compiled
  signature and raises on drift.
- The TF32 flags that the model's ``precision`` sets are process state,
  not part of a graph. Both artifacts record the precision and run under
  ``precision_scope`` of it.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Optional, Sequence

import torch

from ..ops import kernels  # noqa: F401  (registers the priorflow:: ops)
from ..utils.precision import precision_scope

# the artifact's serving facts: in the graph module's meta, in a saved
# program's extra file and in a package's AOTInductor metadata
META_KEY = "priorflow_serving"
META_FILE = "priorflow_serving.json"
# Inductor's settings for a package: a fused kernel rounds each bf16
# intermediate as eager does, where it would otherwise keep it in f32 (on
# an H100 the bf16 package lies 1.2-2.3x nearer eager with it, PERF.md
# §6); f32 code is unchanged
INDUCTOR_CONFIGS = {"emulate_precision_casts": True}


def make_forward(model, iters: int = 12):
    """The pure inference function ``fn(state, image1, image2) -> flow`` of
    ``model``, the unit both artifacts compile: ``torch.func.
    functional_call`` of the test-mode forward with the weights in
    ``state``. Returns only the final upsampled branch-A flow (reference
    core/prior_raft.py:212-213)."""

    # the reference layout registers each strided block's norm3 twice (as
    # downsample.1 too): the state holds both names, and each tensor is
    # swapped once, under its first name (functional_call swapping a
    # twice-registered module's tensor under both names would leave the
    # model holding the swapped-in tensor)
    names = {n for n, _ in model.named_parameters()} | {
        n for n, _ in model.named_buffers()}

    def fn(state, image1, image2):
        weights = {k: v for k, v in state.items() if k in names}
        if weights.keys() != names:
            missing = sorted(names - weights.keys())
            raise ValueError(f"state lacks {missing[:5]}")
        return torch.func.functional_call(
            model, weights, (image1, image2),
            {"iters": iters, "test_mode": True}, tie_weights=False)

    return fn


class _Forward(torch.nn.Module):
    """``make_forward``'s function as the module ``torch.export`` takes. The
    model stays outside this module's tree, so its weights enter the
    program only as the ``state`` input."""

    def __init__(self, model, iters: int):
        super().__init__()
        self._fn = make_forward(model, iters)

    def forward(self, state, image1, image2):
        return self._fn(state, image1, image2)


def _check_platforms(platforms, dev: torch.device) -> None:
    if platforms is not None and list(platforms) != [dev.type]:
        raise ValueError(
            f"platforms {list(platforms)}: an exported program runs on the "
            f"device type it was exported on ({dev.type}); multi-platform "
            f"artifacts need lookup_mode='mxu', ROADMAP Queue 1, item 11")


def export_forward(model, state, input_shape: Sequence[int],
                   iters: int = 12,
                   platforms: Optional[Sequence[str]] = None, device=None):
    """Export the inference forward for ``input_shape`` = (batch, H, W) as a
    ``torch.export.ExportedProgram`` (non-strict), the weights an input.

    ``state``: the weights (name -> tensor) on ``device``, which defaults
    to the card. ``platforms``: the device types the artifact should run
    on; only the export device's is possible.
    """
    from ..models import resolve_device   # the caller holds a model

    dev = resolve_device(device)
    _check_platforms(platforms, dev)
    b, h, w = input_shape
    # every example input its own tensor: the tracer takes one tensor
    # passed twice for one input, so the program would read image1 as
    # image2, or tie two weights the state holds separately
    state = {k: torch.empty_like(v) for k, v in state.items()}
    images = [torch.zeros((b, h, w, 3), dtype=torch.float32, device=dev)
              for _ in range(2)]
    # the model caches its rotation grids per shape: built here, outside
    # the tracer, they enter the program as constants
    model.rotation_grids(h, w, images[0].device)
    exported = torch.export.export(_Forward(model, iters), (state, *images),
                                   strict=False)
    exported.graph_module.meta[META_KEY] = {
        "precision": model.precision, "iters": iters,
        "state_keys": list(state)}
    return exported


def save_exported(exported, path: str) -> None:
    """Write an exported program to ``path`` (a ``.pt2`` file: the graph,
    its specs and the serving facts)."""
    torch.export.save(exported, path, extra_files={
        META_FILE: json.dumps(exported.graph_module.meta[META_KEY])})


def _ordered(state, keys):
    """``state`` as a dict in the artifact's key order; raises on missing
    or extra names."""
    if state.keys() != set(keys):
        missing = sorted(set(keys) - state.keys())
        extra = sorted(state.keys() - set(keys))
        raise ValueError(f"state names differ from the artifact's: missing "
                         f"{missing[:5]}, unexpected {extra[:5]}")
    return {k: state[k] for k in keys}


def load_exported(path: str):
    """Load a saved program; returns ``fn(state, image1, image2) -> flow``,
    run under the recorded precision, with ``fn.exported`` (the
    ``ExportedProgram``) for introspection. Imports no model code."""
    extra = {META_FILE: ""}
    exported = torch.export.load(path, extra_files=extra)
    meta = json.loads(extra[META_FILE])
    exported.graph_module.meta[META_KEY] = meta
    module = exported.module()

    def fn(state, image1, image2):
        with precision_scope(meta["precision"]), torch.no_grad():
            return module(_ordered(state, meta["state_keys"]), image1,
                          image2)

    fn.exported = exported
    return fn


def _user_inputs(exported):
    """The values (FakeTensors) of the program's user inputs, in order:
    the state's tensors, then the two images."""
    vals = {n.name: n.meta["val"] for n in exported.graph.nodes
            if n.op == "placeholder"}
    return [vals[name] for name in exported.graph_signature.user_inputs]


def _aval(t) -> str:
    dtype = str(t.dtype).removeprefix("torch.")
    return f"{dtype}[{','.join(map(str, t.shape))}]"


def exported_summary(exported) -> dict:
    """Human/JSON-facing description of an artifact (used by the CLI)."""
    inputs = _user_inputs(exported)
    out = next(n for n in exported.graph.nodes if n.op == "output")
    outs = [a.meta["val"] for a in out.args[0]]
    return {
        "platforms": sorted({t.device.type for t in inputs}),
        "in_avals": [_aval(t) for t in inputs[-2:]],
        "out_avals": [_aval(t) for t in outs],
        "num_weight_leaves": len(inputs) - 2,
        "precision": exported.graph_module.meta[META_KEY]["precision"],
    }


def _signature(t) -> list:
    """A tensor's (shape, strides, dtype, device), as a package records it."""
    return [list(t.shape), list(t.stride()), str(t.dtype), str(t.device)]


class CompiledForward:
    """The AOTInductor package at ``package_path`` as a forward:
    ``compiled(state, image1, image2) -> flow``. Needs only the package:
    its metadata holds the precision, the state's names and the compiled
    signature. Every input is checked against the signature (shape,
    strides, dtype, device) and the state's names against the compiled
    ones, and a mismatch raises: AOTInductor itself would run an image of
    another shape. The weights are the call's ``state``, so a second state
    gives its own model's flow. Runs under the recorded precision."""

    def __init__(self, package_path: str):
        self.package_path = package_path
        self.runner = torch._inductor.aoti_load_package(package_path)
        facts = self.runner.get_metadata().get(META_KEY)
        if facts is None:
            raise ValueError(f"{package_path}: not a package of "
                             f"serving.aot_compile (no {META_KEY} metadata)")
        meta = json.loads(facts)
        self.precision = meta["precision"]
        self.state_keys = meta["state_keys"]
        self._names = self.state_keys + ["image1", "image2"]
        self._signature = meta["signature"]

    def __call__(self, state, image1, image2):
        state = _ordered(state, self.state_keys)
        flat = [*state.values(), image1, image2]
        for name, t, want in zip(self._names, flat, self._signature):
            got = _signature(t) if isinstance(t, torch.Tensor) else type(t)
            if got != want:
                raise ValueError(
                    f"{name}: got {got}, the package was compiled for "
                    f"(shape, strides, dtype, device) {want}")
        with precision_scope(self.precision), torch.no_grad():
            return self.runner(state, image1, image2)


def aot_compile(model, state, input_shape: Sequence[int], iters: int = 12,
                package_path: Optional[str] = None, device=None):
    """Ahead-of-time compile the inference forward for ``input_shape`` =
    (batch, H, W) with AOTInductor into ``package_path`` (default: a new
    temp dir's ``prior_raft.pt2``), on ``device`` (default: the card).
    Returns a ``CompiledForward``: call it as ``compiled(state, image1,
    image2)``. It raises at call time if an input's shape, strides, dtype
    or device differ from the compiled signature: a serving process must
    never silently run another program. ``CompiledForward(package_path)``
    loads the package again in another process, without the model code.
    Inductor compiles with ``INDUCTOR_CONFIGS``. AOTInductor links the
    package with ``-fopenmp``: Inductor's C++ compiler (``$CXX``, else
    ``g++``) must link OpenMP."""
    exported = export_forward(model, state, input_shape, iters,
                              device=device)
    meta = dict(exported.graph_module.meta[META_KEY],
                signature=[_signature(t) for t in _user_inputs(exported)])
    if package_path is None:
        package_path = os.path.join(tempfile.mkdtemp(prefix="priorflow_aoti_"),
                                    "prior_raft.pt2")
    path = torch._inductor.aoti_compile_and_package(
        exported, package_path=package_path,
        inductor_configs={**INDUCTOR_CONFIGS, "aot_inductor.metadata": {
            META_KEY: json.dumps(meta)}})
    return CompiledForward(path)
