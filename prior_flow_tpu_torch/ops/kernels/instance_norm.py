"""Instance-norm statistics: the CUDA kernel's wrapper, its plain PyTorch
version, and the affine-free instance norm built on them, with its
backward.

Counterpart of ``prior_flow_tpu/ops/pallas/instance_norm.py``
(``_sums_kernel`` via ``_lane_sums``, public op ``instance_norm_fused`` and
its custom VJP); kernel source ``prior_flow_tpu_torch/csrc/instance_norm.cu``.
The forward takes the sums of (x, x), the backward the sums of (xhat, dy). A
tensor on the CPU goes through the plain version; a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build


def instance_norm_sums_plain(x: torch.Tensor, y: torch.Tensor):
    """(B, C, H, W) x2 -> (sum(y), sum(x*y)) over H*W, each (B, C) f32,
    accumulated in f64 as the kernel does (see ``InstanceNormFunction``)."""
    xd, yd = x.double(), y.double()
    return (yd.sum(dim=(2, 3)).float(),
            (xd * yd).sum(dim=(2, 3)).float())


def _kernel():
    fn = _build.load_library().lib.instance_norm_sums
    p = ctypes.c_void_p
    fn.argtypes = [p, p, ctypes.c_int, p, p, ctypes.c_int, ctypes.c_longlong, p]
    fn.restype = ctypes.c_int
    return fn


def instance_norm_sums(x: torch.Tensor, y: torch.Tensor):
    """Per-(sample, channel) f32 sums of y and x*y over H*W of NCHW inputs;
    y = x gives the forward moments."""
    if x.device.type == "cpu":
        return instance_norm_sums_plain(x, y)
    if x.device.type != "cuda":
        raise RuntimeError(f"instance_norm_sums: no kernel for device {x.device}")
    if y.device != x.device or y.shape != x.shape or y.dtype != x.dtype:
        raise ValueError("instance_norm_sums: x and y must share device, "
                         "shape and dtype")
    if x.dim() != 4:
        raise ValueError(f"instance_norm_sums: expected NCHW, got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"instance_norm_sums: float32 or bfloat16, got {x.dtype}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("instance_norm_sums: inputs must be contiguous NCHW")
    B, C, H, W = x.shape
    s1 = torch.empty((B, C), dtype=torch.float32, device=x.device)
    s2 = torch.empty((B, C), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _kernel()(x.data_ptr(), y.data_ptr(),
                           int(x.dtype == torch.bfloat16), s1.data_ptr(),
                           s2.data_ptr(), B * C, H * W, stream)
    _build.check(status, "instance_norm_sums")
    instance_norm_sums.launches += 1
    return s1, s2


instance_norm_sums.launches = 0


class InstanceNormFunction(torch.autograd.Function):
    """Affine-free instance norm of NCHW ``x`` with the JAX package's VJP
    (``prior_flow_tpu/ops/pallas/instance_norm.py:17-23,143-157``):

        dx = s * (dy - mean(dy) - xhat * mean(dy * xhat)),  s = rsqrt(var+eps)

    The forward's moments come from the op ``priorflow::instance_norm_sums``
    (``library.py``), the backward's from the wrapper. Both means come from
    the sums kernel, run on (xhat, dy) in f32: the same two sums as the JAX
    kernel's (x, dy), but centred, so mean(dy * xhat) is not the difference
    s * mean(dy * x) - s * m * mean(dy), which cancels when a channel's
    mean is large against its spread. The
    normalisation is centred too, (x - m) * s, as the JAX CPU path
    (``prior_flow_tpu/nn/layers.py:66-77``) computes it. The sums are
    accumulated in f64 (kernel and plain version alike): the encoder's
    weight gradients follow the rounding of these sums, and with f32
    sums they lay ~2e-3 from a float64 evaluation
    (``tests/test_torch_port_train.py::test_encoder_grads_near_float64``)."""

    @staticmethod
    def forward(ctx, x, eps: float, out_dtype):
        n = x.shape[2] * x.shape[3]
        s1, s2 = torch.ops.priorflow.instance_norm_sums(x, x)
        m = s1 / n
        var = torch.clamp_min(s2 / n - m * m, 0.0)
        s = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, m, s)
        return ((x.float() - m[:, :, None, None]) * s[:, :, None, None]).to(
            out_dtype or x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, m, s = ctx.saved_tensors
        n = x.shape[2] * x.shape[3]
        a = s[:, :, None, None]
        xhat = (x.float() - m[:, :, None, None]) * a
        dyf = dy.float().contiguous()
        d1, d2 = instance_norm_sums(xhat, dyf)
        dx = a * (dyf - (d1 / n)[:, :, None, None]
                  - xhat * (d2 / n)[:, :, None, None])
        return dx.to(x.dtype), None, None


def instance_norm(x: torch.Tensor, eps: float = 1e-5, out_dtype=None):
    """Affine-free instance norm of NCHW ``x`` (torch InstanceNorm2d).

    One-pass statistics E[x^2] - E[x]^2 from f64-accumulated sums, in f32,
    clamped at 0 (``prior_flow_tpu/nn/layers.py:66-73``); the
    normalisation ``(x - m) * s`` runs in f32 and rounds once to
    ``out_dtype`` (default x.dtype).
    Differentiable through ``InstanceNormFunction``.
    """
    return InstanceNormFunction.apply(x, eps, out_dtype)
