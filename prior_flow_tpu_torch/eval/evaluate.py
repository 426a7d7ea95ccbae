"""Validators: EPE and SEPE over the panoramic and perspective benchmarks,
and the Sintel and KITTI submission writers (counterpart of
``prior_flow_tpu/eval/evaluate.py``).

The metric semantics are the JAX module's:

- ``validate_mpf`` / ``validate_flowscape``: pad to /8, EPE over the
  concatenated pixels of every sample, SEPE as the mean of per-image
  means;
- the ``*_regions`` variants: EPE and SEPE over {All, Equator, Poles,
  Center} in one pass over the data; ``validate_city_regions`` adds the
  cos-weighted ``sd_uni`` on the MPF City test split;
- the perspective validators (chairs, Sintel, KITTI) and the submissions.

Each validator takes the port's model, an ``nn.Module`` on its device,
and runs there: the images go to the model's device, where the per-pixel
errors and distances are computed and summed in float64; the host reads
one result per validator. Consecutive samples of one shape share a
forward of up to ``batch_size`` pairs; a short last group runs as it is
(the per-sample metrics do not depend on the batch).

``clock``, where given, is an ``EvalClock``: it adds the host seconds of
each stage of the loop (read, pad, forward, metrics) and synchronises the
device at each stage's end, so that each stage's time is its own.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import numpy as np
import torch

from ..data import datasets as ds
from ..data import frame_utils
from ..utils.padder import InputPadder
from . import metrics as M

F64 = torch.float64


class EvalClock:
    """Host seconds per stage of the evaluation loop and the pairs it
    evaluated; each stage ends with a device synchronise."""

    def __init__(self):
        self.seconds = defaultdict(float)
        self.pairs = 0

    @contextlib.contextmanager
    def __call__(self, stage: str, device: torch.device):
        t0 = time.perf_counter()
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.seconds[stage] += time.perf_counter() - t0


def _no_clock(stage, device):
    return contextlib.nullcontext()


def model_device(model) -> torch.device:
    """The device of the model's first parameter or buffer (the CPU for a
    module that holds neither)."""
    for t in (*model.parameters(), *model.buffers()):
        return t.device
    return torch.device("cpu")


def make_forward(model, iters: int = 12):
    """The test-mode forward of ``model`` at ``iters`` GRU iterations."""

    def run(image1, image2):
        return model(image1, image2, iters=iters)

    return run


def _iter_flows(forward, val, n, device, batch_size=1, padder_mode="sintel",
                clock=None):
    """Yield ``(index, flow, sample)`` per sample: ``flow`` (H, W, 2) on
    ``device``, ``sample`` the dataset's numpy tuple. Consecutive samples
    of one shape are grouped up to ``batch_size`` per forward. Counts the
    pairs on ``clock``."""
    tick = clock or _no_clock
    buf = []

    def flush():
        if not buf:
            return
        idx = [i for i, _ in buf]
        samples = [s for _, s in buf]
        buf.clear()
        with tick("pad", device):
            imgs1 = torch.from_numpy(np.stack(
                [np.asarray(s[0], np.float32) for s in samples])).to(device)
            imgs2 = torch.from_numpy(np.stack(
                [np.asarray(s[1], np.float32) for s in samples])).to(device)
            padder = InputPadder(imgs1.shape, mode=padder_mode)
            i1, i2 = padder.pad(imgs1, imgs2)
        with tick("forward", device):
            flows = padder.unpad(forward(i1, i2))
        for j in range(len(idx)):
            if clock is not None:
                clock.pairs += 1
            yield idx[j], flows[j], samples[j]

    for i in range(n):
        with tick("read", device):
            sample = val[i]
        if buf and np.shape(sample[0]) != np.shape(buf[-1][1][0]):
            yield from flush()
        buf.append((i, sample))
        if len(buf) == batch_size:
            yield from flush()
    yield from flush()


def _count(val, max_samples):
    return len(val) if max_samples is None else min(len(val), max_samples)


def _root(data_root):
    return {"root": data_root} if data_root else {}


def validate_mpf(model, iters: int = 12, scene: str = "EFT",
                 data_root: Optional[str] = None, max_samples=None,
                 batch_size: int = 1, clock=None) -> Dict:
    """EPE + mean SEPE on the MPF test split
    (``prior_flow_tpu/eval/evaluate.py:103``)."""
    val = ds.MPFDataset(split="test", scene=scene, **_root(data_root))
    return _validate_dense(model, val, iters, name=scene,
                           max_samples=max_samples, batch_size=batch_size,
                           clock=clock)


def validate_flowscape(model, iters: int = 12, scene: str = "sunny",
                       data_root: Optional[str] = None, max_samples=None,
                       batch_size: int = 1, clock=None) -> Dict:
    """EPE + mean SEPE on FlowScape
    (``prior_flow_tpu/eval/evaluate.py:113``)."""
    val = ds.FlowScape(split="test", scene=scene, **_root(data_root))
    return _validate_dense(model, val, iters, name=f"FlowScape-{scene}",
                           max_samples=max_samples, batch_size=batch_size,
                           clock=clock)


def _validate_dense(model, val, iters, name, max_samples=None, batch_size=1,
                    clock=None):
    dev = model_device(model)
    tick = clock or _no_clock
    forward = make_forward(model, iters)
    epe_sum = torch.zeros((), dtype=F64, device=dev)
    sd_sum = torch.zeros((), dtype=F64, device=dev)
    pixels = images = 0
    n = _count(val, max_samples)
    for _, flow, sample in _iter_flows(forward, val, n, dev, batch_size,
                                       clock=clock):
        with tick("metrics", dev):
            gt = torch.from_numpy(np.asarray(sample[2], np.float32)).to(dev)
            err = M.epe(flow[None], gt[None])
            sd = M.great_circle_distance(flow[None], gt[None])
            epe_sum += err.sum(dtype=F64)
            sd_sum += sd.mean(dtype=F64)
            pixels += err.numel()
            images += 1
    epe = float(epe_sum) / pixels
    sepe = float(sd_sum) / images
    print(f"Validation ({name}) EPE: {epe:f}, SEPE: {sepe:f}")
    return {f"{name}-epe": epe, f"{name}-SEPE": sepe}


REGIONS = M.REGIONS


def _validate_regions(model, val, iters, name, with_sd_uni=False,
                      max_samples=None, batch_size=1, clock=None):
    """One pass: per-region EPE over concatenated pixels, SEPE as the mean
    of per-image region means, and optionally the cos-weighted sd_uni."""
    dev = model_device(model)
    tick = clock or _no_clock
    forward = make_forward(model, iters)
    masks = weights = None
    R = len(REGIONS)
    epe_sum = torch.zeros(R, dtype=F64, device=dev)
    sd_sum = torch.zeros(R, dtype=F64, device=dev)
    sd_uni_sum = torch.zeros(R, dtype=F64, device=dev)
    images = 0
    n = _count(val, max_samples)
    for _, flow, sample in _iter_flows(forward, val, n, dev, batch_size,
                                       clock=clock):
        with tick("metrics", dev):
            gt = torch.from_numpy(np.asarray(sample[2], np.float32)).to(dev)
            if masks is None:
                H, W = gt.shape[:2]
                named = M.region_masks(H, W)
                masks = torch.from_numpy(np.stack(
                    [named[r].reshape(-1) for r in REGIONS])).to(dev, F64)
                uniform = torch.tensor(M.spherical_mask(H, W).reshape(-1),
                                       dtype=F64, device=dev)
                weights = masks * uniform
                pixels = masks.sum(dim=1)
            err = M.epe(flow[None], gt[None]).reshape(-1).to(F64)
            sd = M.great_circle_distance(flow[None],
                                         gt[None]).reshape(-1).to(F64)
            epe_sum += (masks * err).sum(dim=1)
            sd_sum += (masks * sd).sum(dim=1) / pixels
            if with_sd_uni:
                sd_uni_sum += (weights * sd).sum(dim=1) / weights.sum(dim=1)
            images += 1
    epe = (epe_sum / (pixels * images)).tolist()
    sd = (sd_sum / images).tolist()
    sd_uni = (sd_uni_sum / images).tolist()

    results = {}
    for k, r in enumerate(REGIONS):
        entry = {"epe": epe[k], "sd": sd[k]}
        if with_sd_uni:
            entry["sd_uni"] = sd_uni[k]
        results[r] = entry
        extra = f", sd_uni {entry['sd_uni']:.8f}" if with_sd_uni else ""
        print(f"{r:>7}-{name}: epe {epe[k]: .3f}, sd {sd[k]: .8f}{extra}")
    return results


def validate_mpf_regions(model, iters: int = 12, scene: str = "EFT",
                         data_root: Optional[str] = None, max_samples=None,
                         batch_size: int = 1, clock=None):
    """Per-region EPE and SEPE on the MPF test split
    (``prior_flow_tpu/eval/evaluate.py:186``)."""
    val = ds.MPFDataset(split="test", scene=scene, **_root(data_root))
    return _validate_regions(model, val, iters, scene,
                             max_samples=max_samples, batch_size=batch_size,
                             clock=clock)


def validate_flowscape_regions(model, iters: int = 12, scene: str = "sunny",
                               data_root: Optional[str] = None,
                               max_samples=None, batch_size: int = 1,
                               clock=None):
    """Per-region EPE and SEPE on FlowScape
    (``prior_flow_tpu/eval/evaluate.py:195``)."""
    val = ds.FlowScape(split="test", scene=scene, **_root(data_root))
    return _validate_regions(model, val, iters, f"FlowScape-{scene}",
                             max_samples=max_samples, batch_size=batch_size,
                             clock=clock)


def validate_city_regions(model, iters: int = 24,
                          data_root: Optional[str] = None, max_samples=None,
                          batch_size: int = 1, clock=None):
    """The MPF City test split with the cos-weighted sd_uni as well
    (``prior_flow_tpu/eval/evaluate.py:206``)."""
    val = ds.MPFDataset(split="test", scene="City", **_root(data_root))
    return _validate_regions(model, val, iters, "city", with_sd_uni=True,
                             max_samples=max_samples, batch_size=batch_size,
                             clock=clock)


# -- the perspective validators (prior_flow_tpu/eval/evaluate.py:223-286) --

def _epe_over_pixels(model, val, iters, max_samples, batch_size):
    """Sums over every pixel of every sample: (EPE, < 1 px, < 3 px,
    < 5 px) in float64, and the pixel count."""
    dev = model_device(model)
    sums = torch.zeros(4, dtype=F64, device=dev)
    pixels = 0
    for _, flow, sample in _iter_flows(make_forward(model, iters), val,
                                       _count(val, max_samples), dev,
                                       batch_size):
        gt = torch.from_numpy(np.asarray(sample[2], np.float32)).to(dev)
        err = M.epe(flow[None], gt[None]).reshape(-1)
        sums += torch.stack([err.sum(dtype=F64)]
                            + [(err < t).sum(dtype=F64) for t in (1, 3, 5)])
        pixels += err.numel()
    return (sums / pixels).tolist()


def validate_chairs(model, iters: int = 24, data_root: Optional[str] = None,
                    max_samples=None, batch_size: int = 1):
    """EPE on the FlyingChairs validation split
    (``prior_flow_tpu/eval/evaluate.py:223``)."""
    val = ds.FlyingChairs(split="validation", **_root(data_root))
    epe = _epe_over_pixels(model, val, iters, max_samples, batch_size)[0]
    print(f"Validation Chairs EPE: {epe:f}")
    return {"chairs": epe}


def validate_sintel(model, iters: int = 32, data_root: Optional[str] = None,
                    max_samples=None, batch_size: int = 1):
    """EPE and the 1/3/5 px shares on both Sintel passes
    (``prior_flow_tpu/eval/evaluate.py:239``)."""
    results = {}
    for dstype in ("clean", "final"):
        val = ds.MpiSintel(split="training", dstype=dstype,
                           **_root(data_root))
        epe, px1, px3, px5 = _epe_over_pixels(model, val, iters, max_samples,
                                              batch_size)
        print(f"Validation ({dstype}) EPE: {epe:f}, 1px: {px1:f}, "
              f"3px: {px3:f}, 5px: {px5:f}")
        results[dstype] = epe
    return results


def validate_kitti(model, iters: int = 24, data_root: Optional[str] = None,
                   max_samples=None, batch_size: int = 1):
    """KITTI 2015 EPE (mean of per-image means over valid pixels) and F1
    (outliers over every valid pixel)
    (``prior_flow_tpu/eval/evaluate.py:260``)."""
    val = ds.KITTI(split="training", **_root(data_root))
    dev = model_device(model)
    epe_sum = torch.zeros((), dtype=F64, device=dev)
    out_sum = torch.zeros((), dtype=F64, device=dev)
    images = valid_pixels = 0
    for _, flow, sample in _iter_flows(make_forward(model, iters), val,
                                       _count(val, max_samples), dev,
                                       batch_size, padder_mode="kitti"):
        gt = torch.from_numpy(np.asarray(sample[2], np.float32)).to(dev)
        v = torch.from_numpy(np.asarray(sample[3]).reshape(-1) >= 0.5).to(dev)
        err = M.epe(flow[None], gt[None]).reshape(-1)
        mag = torch.sqrt(torch.sum(gt ** 2, dim=-1)).reshape(-1)
        out = (err > 3.0) & ((err / torch.clamp(mag, min=1e-9)) > 0.05)
        epe_sum += err[v].mean(dtype=F64)
        out_sum += out[v].sum(dtype=F64)
        images += 1
        valid_pixels += int(np.count_nonzero(np.asarray(sample[3]) >= 0.5))
    epe = float(epe_sum) / images
    f1 = 100 * float(out_sum) / valid_pixels
    print(f"Validation KITTI: {epe:f}, {f1:f}")
    return {"kitti-epe": epe, "kitti-f1": f1}


# -- submission writers (prior_flow_tpu/eval/evaluate.py:289-329) ----------

def _batch(img, dev):
    return torch.from_numpy(np.asarray(img, np.float32))[None].to(dev)


def create_sintel_submission(model, iters: int = 32, warm_start: bool = False,
                             output_path: str = "sintel_submission",
                             data_root: Optional[str] = None):
    """Write the final upsampled flow of every Sintel test pair as .flo;
    with ``warm_start`` each sequence's next pair starts from the previous
    flow at 1/8 (``prior_flow_tpu/eval/evaluate.py:289``)."""
    from ..ops.warp import downflow8

    dev = model_device(model)
    for dstype in ("clean", "final"):
        test = ds.MpiSintel(split="test", aug_params=None, dstype=dstype,
                            **_root(data_root))
        flow_prev, seq_prev = None, None
        for i in range(len(test)):
            img1, img2, (sequence, frame) = test[i]
            if sequence != seq_prev:
                flow_prev = None
            i1, i2 = _batch(img1, dev), _batch(img2, dev)
            padder = InputPadder(i1.shape)
            i1, i2 = padder.pad(i1, i2)
            flow = model(i1, i2, iters=iters, init_flow=flow_prev)
            flow_np = padder.unpad(flow)[0].cpu().numpy()
            if warm_start:
                flow_prev = downflow8(flow)
            out_dir = os.path.join(output_path, dstype, sequence)
            os.makedirs(out_dir, exist_ok=True)
            frame_utils.write_flo(
                os.path.join(out_dir, "frame%04d.flo" % (frame + 1)), flow_np)
            seq_prev = sequence


def create_kitti_submission(model, iters: int = 24,
                            output_path: str = "kitti_submission",
                            data_root: Optional[str] = None):
    """Write the flow of every KITTI test pair as a 16-bit PNG
    (``prior_flow_tpu/eval/evaluate.py:317``)."""
    dev = model_device(model)
    test = ds.KITTI(split="testing", aug_params=None, **_root(data_root))
    os.makedirs(output_path, exist_ok=True)
    for i in range(len(test)):
        img1, img2, (frame_id,) = test[i]
        i1, i2 = _batch(img1, dev), _batch(img2, dev)
        padder = InputPadder(i1.shape, mode="kitti")
        i1, i2 = padder.pad(i1, i2)
        flow = padder.unpad(model(i1, i2, iters=iters))[0].cpu().numpy()
        frame_utils.write_flow_kitti(os.path.join(output_path, frame_id), flow)
