"""Data augmentation (counterpart of ``prior_flow_tpu/data/augmentor.py``):
host-side numpy and cv2, on the port's own ``data/native.py`` for the
roll, the eraser's rectangle paint and its mean colour.

- ``color_jitter``: brightness, contrast, saturation and hue in a random
  order, torchvision ColorJitter's factor ranges;
- ``_eraser``: mean-colour rectangles painted into the second frame;
- ``FlowAugmentor360``: colour, eraser and the horizontal roll of an ERP
  panorama (resize and flip exist as methods but are not applied, as in
  the JAX package);
- ``FlowAugmentor``: the perspective scale / stretch / flip / crop;
- ``SparseFlowAugmentor`` and its 360° twin: the nearest-splat resize of
  sparse flow; the two ``*Ortho`` variants carry the orthogonal views
  through the same photometric pipeline.

Every ``__call__`` takes an optional ``rng`` (``np.random.RandomState``):
the datasets pass one per sample, keyed by (seed, epoch, index), so a
batch does not depend on the loader's worker count. Under the same
RandomState the images and flow are bitwise the JAX module's.
"""

from __future__ import annotations

import numpy as np

from . import native

try:
    import cv2
    cv2.setNumThreads(0)
    cv2.ocl.setUseOpenCL(False)
except ImportError:  # pragma: no cover
    cv2 = None


# ---------------------------------------------------------------------------
# photometric jitter (torchvision ColorJitter semantics, numpy)
# ---------------------------------------------------------------------------

def _blend(a, b, factor):
    return np.clip(factor * a + (1.0 - factor) * b, 0, 255)


def _grayscale(img):
    # ITU-R 601-2 luma, like PIL convert('L')
    return img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114


def color_jitter(img, brightness=0.4, contrast=0.4, saturation=0.4,
                 hue=0.5 / 3.14, rng=np.random):
    """Apply brightness/contrast/saturation/hue jitter in random order."""
    img = img.astype(np.float32)
    ops = list(rng.permutation(4))
    for op in ops:
        if op == 0 and brightness > 0:
            f = rng.uniform(max(0, 1 - brightness), 1 + brightness)
            img = np.clip(img * f, 0, 255)
        elif op == 1 and contrast > 0:
            f = rng.uniform(max(0, 1 - contrast), 1 + contrast)
            mean = _grayscale(img).mean()
            img = _blend(img, mean, f)
        elif op == 2 and saturation > 0:
            f = rng.uniform(max(0, 1 - saturation), 1 + saturation)
            gray = _grayscale(img)[..., None]
            img = _blend(img, gray, f)
        elif op == 3 and hue > 0 and cv2 is not None:
            f = rng.uniform(-hue, hue)
            hsv = cv2.cvtColor(img.astype(np.uint8), cv2.COLOR_RGB2HSV)
            h = hsv[..., 0].astype(np.int32)
            hsv[..., 0] = ((h + int(round(f * 180))) % 180).astype(hsv.dtype)
            img = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB).astype(np.float32)
    return img.astype(np.uint8)


def _eraser(img1, img2, bounds, prob, rng):
    """Occlusion augmentation: paint mean-colour rectangles into img2
    (``prior_flow_tpu/data/augmentor.py:80``)."""
    ht, wd = img1.shape[:2]
    if rng.rand() < prob:
        mean_color = native.mean_color(img2)
        for _ in range(rng.randint(1, 3)):
            x0 = rng.randint(0, wd)
            y0 = rng.randint(0, ht)
            dx = rng.randint(bounds[0], bounds[1])
            dy = rng.randint(bounds[0], bounds[1])
            native.erase_rect(img2, x0, y0, dx, dy, mean_color)
    return img1, img2


def _rng(rng, default):
    """The draws of one call: ``rng``, else the augmentor's own, else the
    global ``np.random``. (The augmentors hold None rather than the
    ``np.random`` module, which does not pickle into a loader worker.)"""
    if rng is not None:
        return rng
    return np.random if default is None else default


def u_clip_np(u, W):
    return (u + W / 2.0) % W - W / 2.0


# ---------------------------------------------------------------------------
# 360° augmentor (``prior_flow_tpu/data/augmentor.py:103``)
# ---------------------------------------------------------------------------

class FlowAugmentor360:
    """Colour jitter + eraser + horizontal-roll rotation for ERP panoramas.

    Resize and flip exist as methods but are not applied, as in the JAX
    module's ``__call__``.
    """

    def __init__(self, resize_size=None, do_flip=True, rng=None):
        self.resize_size = None if resize_size is None else \
            [resize_size[1], resize_size[0]]  # [w, h] opencv order
        self.do_flip = do_flip
        self.h_flip_prob = 0.5
        self.v_flip_prob = 0.1
        self.photo_params = dict(brightness=0.4, contrast=0.4,
                                 saturation=0.4, hue=0.5 / 3.14)
        self.asymmetric_color_aug_prob = 0.2
        self.eraser_aug_prob = 0.5
        self.rotate_ratio = 0.2
        self.rotation_aug_prob = 0.5
        self.asymmetric_rotation_aug_prob = 0.0
        self.rng = rng

    def color_transform(self, img1, img2, rng=None):
        rng = _rng(rng, self.rng)
        if rng.rand() < self.asymmetric_color_aug_prob:
            img1 = color_jitter(img1, rng=rng, **self.photo_params)
            img2 = color_jitter(img2, rng=rng, **self.photo_params)
        else:
            stack = np.concatenate([img1, img2], axis=0)
            stack = color_jitter(stack, rng=rng, **self.photo_params)
            img1, img2 = np.split(stack, 2, axis=0)
        return img1, img2

    def eraser_transform(self, img1, img2, bounds=(50, 100), rng=None):
        rng = _rng(rng, self.rng)
        return _eraser(img1, img2, bounds, self.eraser_aug_prob, rng)

    def rotation_transform(self, img1, img2, flow, rng=None):
        """Horizontal roll by up to +-rotate_ratio*W pixels (the native
        library's roll where it is loaded, else ``np.roll``)."""
        _, wd = img1.shape[:2]
        rng = _rng(rng, self.rng)
        max_px = int(np.round(self.rotate_ratio * wd))
        if rng.rand() >= self.rotation_aug_prob:
            return img1, img2, flow
        if rng.rand() < self.asymmetric_rotation_aug_prob:
            k1 = rng.randint(-max_px, max_px)
            k2 = rng.randint(-max_px, max_px)
            img1 = native.roll(img1, k1)
            flow = native.roll(flow, k1).copy()
            img2 = native.roll(img2, k2)
            flow[:, :, 0] = u_clip_np(flow[:, :, 0] + k2 - k1, wd)
            return img1, img2, flow
        k = rng.randint(-max_px, max_px)
        return (native.roll(img1, k), native.roll(img2, k),
                native.roll(flow, k))

    def flip_transform(self, img1, img2, flow, rng=None):
        rng = _rng(rng, self.rng)
        if self.do_flip:
            if rng.rand() < self.h_flip_prob:
                img1 = img1[:, ::-1]
                img2 = img2[:, ::-1]
                flow = flow[:, ::-1] * [-1.0, 1.0]
            if rng.rand() < self.v_flip_prob:
                img1 = img1[::-1, :]
                img2 = img2[::-1, :]
                flow = flow[::-1, :] * [1.0, -1.0]
        return img1, img2, flow

    def resize_transform(self, img1, img2, flow):
        sx = self.resize_size[0] / img1.shape[1]
        sy = self.resize_size[1] / img1.shape[0]
        img1 = cv2.resize(img1, tuple(self.resize_size), interpolation=cv2.INTER_LINEAR)
        img2 = cv2.resize(img2, tuple(self.resize_size), interpolation=cv2.INTER_LINEAR)
        flow = cv2.resize(flow, tuple(self.resize_size), interpolation=cv2.INTER_LINEAR)
        return img1, img2, flow * [sx, sy]

    def __call__(self, img1, img2, flow, rng=None):
        img1, img2 = self.color_transform(img1, img2, rng=rng)
        img1, img2 = self.eraser_transform(img1, img2, rng=rng)
        # resize and flip are not applied, as in the JAX module
        img1, img2, flow = self.rotation_transform(img1, img2, flow, rng=rng)
        return (np.ascontiguousarray(img1), np.ascontiguousarray(img2),
                np.ascontiguousarray(flow))


# ---------------------------------------------------------------------------
# perspective augmentor (``prior_flow_tpu/data/augmentor.py:196``)
# ---------------------------------------------------------------------------

class FlowAugmentor:
    """Scale/stretch/flip/crop pipeline for perspective datasets."""

    def __init__(self, crop_size, min_scale=-0.2, max_scale=0.5, do_flip=True,
                 rng=None):
        self.crop_size = crop_size
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.spatial_aug_prob = 0.8
        self.stretch_prob = 0.8
        self.max_stretch = 0.2
        self.do_flip = do_flip
        self.h_flip_prob = 0.5
        self.v_flip_prob = 0.1
        self.photo_params = dict(brightness=0.4, contrast=0.4,
                                 saturation=0.4, hue=0.5 / 3.14)
        self.asymmetric_color_aug_prob = 0.2
        self.eraser_aug_prob = 0.5
        self.rng = rng

    def color_transform(self, img1, img2, rng=None):
        rng = _rng(rng, self.rng)
        if rng.rand() < self.asymmetric_color_aug_prob:
            img1 = color_jitter(img1, rng=rng, **self.photo_params)
            img2 = color_jitter(img2, rng=rng, **self.photo_params)
        else:
            stack = np.concatenate([img1, img2], axis=0)
            stack = color_jitter(stack, rng=rng, **self.photo_params)
            img1, img2 = np.split(stack, 2, axis=0)
        return img1, img2

    def eraser_transform(self, img1, img2, bounds=(50, 100), rng=None):
        rng = _rng(rng, self.rng)
        return _eraser(img1, img2, bounds, self.eraser_aug_prob, rng)

    def spatial_transform(self, img1, img2, flow, rng=None):
        rng = _rng(rng, self.rng)
        ht, wd = img1.shape[:2]
        min_scale = max((self.crop_size[0] + 8) / float(ht),
                        (self.crop_size[1] + 8) / float(wd))
        scale = 2 ** rng.uniform(self.min_scale, self.max_scale)
        scale_x = scale_y = scale
        if rng.rand() < self.stretch_prob:
            scale_x *= 2 ** rng.uniform(-self.max_stretch, self.max_stretch)
            scale_y *= 2 ** rng.uniform(-self.max_stretch, self.max_stretch)
        scale_x = np.clip(scale_x, min_scale, None)
        scale_y = np.clip(scale_y, min_scale, None)
        if rng.rand() < self.spatial_aug_prob:
            img1 = cv2.resize(img1, None, fx=scale_x, fy=scale_y,
                              interpolation=cv2.INTER_LINEAR)
            img2 = cv2.resize(img2, None, fx=scale_x, fy=scale_y,
                              interpolation=cv2.INTER_LINEAR)
            flow = cv2.resize(flow, None, fx=scale_x, fy=scale_y,
                              interpolation=cv2.INTER_LINEAR)
            flow = flow * [scale_x, scale_y]
        if self.do_flip:
            if rng.rand() < self.h_flip_prob:
                img1 = img1[:, ::-1]
                img2 = img2[:, ::-1]
                flow = flow[:, ::-1] * [-1.0, 1.0]
            if rng.rand() < self.v_flip_prob:
                img1 = img1[::-1, :]
                img2 = img2[::-1, :]
                flow = flow[::-1, :] * [1.0, -1.0]
        y0 = rng.randint(0, img1.shape[0] - self.crop_size[0])
        x0 = rng.randint(0, img1.shape[1] - self.crop_size[1])
        sl = np.s_[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        return img1[sl], img2[sl], flow[sl]

    def __call__(self, img1, img2, flow, rng=None):
        img1, img2 = self.color_transform(img1, img2, rng=rng)
        img1, img2 = self.eraser_transform(img1, img2, rng=rng)
        img1, img2, flow = self.spatial_transform(img1, img2, flow, rng=rng)
        return (np.ascontiguousarray(img1), np.ascontiguousarray(img2),
                np.ascontiguousarray(flow))


# ---------------------------------------------------------------------------
# sparse-flow augmentors (``prior_flow_tpu/data/augmentor.py:277-392``)
# ---------------------------------------------------------------------------

class SparseFlowAugmentor:
    """KITTI-style sparse flow: nearest-splat resize of valid flow samples."""

    def __init__(self, crop_size, min_scale=-0.2, max_scale=0.5, do_flip=False,
                 rng=None):
        self.crop_size = crop_size
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.spatial_aug_prob = 0.8
        self.do_flip = do_flip
        self.photo_params = dict(brightness=0.3, contrast=0.3,
                                 saturation=0.3, hue=0.3 / 3.14)
        self.eraser_aug_prob = 0.5
        self.rng = rng

    def color_transform(self, img1, img2, rng=None):
        rng = _rng(rng, self.rng)
        stack = np.concatenate([img1, img2], axis=0)
        stack = color_jitter(stack, rng=rng, **self.photo_params)
        return tuple(np.split(stack, 2, axis=0))

    def eraser_transform(self, img1, img2, rng=None):
        rng = _rng(rng, self.rng)
        return _eraser(img1, img2, (50, 100), self.eraser_aug_prob, rng)

    @staticmethod
    def resize_sparse_flow_map(flow, valid, fx=1.0, fy=1.0):
        ht, wd = flow.shape[:2]
        coords = np.stack(np.meshgrid(np.arange(wd), np.arange(ht)), -1)
        coords = coords.reshape(-1, 2).astype(np.float32)
        flow_f = flow.reshape(-1, 2).astype(np.float32)
        valid_f = valid.reshape(-1).astype(np.float32)
        coords0 = coords[valid_f >= 1]
        flow0 = flow_f[valid_f >= 1]
        ht1, wd1 = int(round(ht * fy)), int(round(wd * fx))
        coords1 = coords0 * [fx, fy]
        flow1 = flow0 * [fx, fy]
        xx = np.round(coords1[:, 0]).astype(np.int32)
        yy = np.round(coords1[:, 1]).astype(np.int32)
        keep = (xx > 0) & (xx < wd1) & (yy > 0) & (yy < ht1)
        flow_img = np.zeros([ht1, wd1, 2], dtype=np.float32)
        valid_img = np.zeros([ht1, wd1], dtype=np.int32)
        flow_img[yy[keep], xx[keep]] = flow1[keep]
        valid_img[yy[keep], xx[keep]] = 1
        return flow_img, valid_img

    def spatial_transform(self, img1, img2, flow, valid, rng=None):
        rng = _rng(rng, self.rng)
        ht, wd = img1.shape[:2]
        min_scale = max((self.crop_size[0] + 1) / float(ht),
                        (self.crop_size[1] + 1) / float(wd))
        scale = 2 ** rng.uniform(self.min_scale, self.max_scale)
        scale_x = np.clip(scale, min_scale, None)
        scale_y = np.clip(scale, min_scale, None)
        if rng.rand() < self.spatial_aug_prob:
            img1 = cv2.resize(img1, None, fx=scale_x, fy=scale_y,
                              interpolation=cv2.INTER_LINEAR)
            img2 = cv2.resize(img2, None, fx=scale_x, fy=scale_y,
                              interpolation=cv2.INTER_LINEAR)
            flow, valid = self.resize_sparse_flow_map(flow, valid, scale_x, scale_y)
        if self.do_flip and rng.rand() < 0.5:
            img1 = img1[:, ::-1]
            img2 = img2[:, ::-1]
            flow = flow[:, ::-1] * [-1.0, 1.0]
            valid = valid[:, ::-1]
        margin_y, margin_x = 20, 50
        y0 = rng.randint(0, img1.shape[0] - self.crop_size[0] + margin_y)
        x0 = rng.randint(-margin_x, img1.shape[1] - self.crop_size[1] + margin_x)
        y0 = int(np.clip(y0, 0, img1.shape[0] - self.crop_size[0]))
        x0 = int(np.clip(x0, 0, img1.shape[1] - self.crop_size[1]))
        sl = np.s_[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        return img1[sl], img2[sl], flow[sl], valid[sl]

    def __call__(self, img1, img2, flow, valid, rng=None):
        img1, img2 = self.color_transform(img1, img2, rng=rng)
        img1, img2 = self.eraser_transform(img1, img2, rng=rng)
        img1, img2, flow, valid = self.spatial_transform(img1, img2, flow,
                                                         valid, rng=rng)
        return (np.ascontiguousarray(img1), np.ascontiguousarray(img2),
                np.ascontiguousarray(flow), np.ascontiguousarray(valid))


class SparseFlowAugmentor360(SparseFlowAugmentor):
    """360° sparse variant: the same
    pipeline with the sparse-splat resize; no roll augmentation."""


class FlowAugmentor360Ortho(FlowAugmentor360):
    """Variant that additionally carries precomputed B-branch (orthogonal)
    views through the same photometric pipeline (unused by the CLIs)."""

    def __call__(self, img1_A, img2_A, flow, img1_B, img2_B, rng=None):
        img1_A, img2_A = self.color_transform(img1_A, img2_A, rng=rng)
        img1_B, img2_B = self.color_transform(img1_B, img2_B, rng=rng)
        img1_A, img2_A = self.eraser_transform(img1_A, img2_A, rng=rng)
        img1_B, img2_B = self.eraser_transform(img1_B, img2_B, rng=rng)
        img1_A, img2_A, flow = self.rotation_transform(img1_A, img2_A, flow,
                                                       rng=rng)
        return tuple(np.ascontiguousarray(a) for a in
                     (img1_A, img2_A, flow, img1_B, img2_B))


class SparseFlowAugmentor360Ortho(SparseFlowAugmentor360):
    """Sparse counterpart of the ortho-view augmentor (unused by the
    CLIs)."""

    def __call__(self, img1_A, img2_A, flow, valid, img1_B, img2_B, rng=None):
        img1_A, img2_A = self.color_transform(img1_A, img2_A, rng=rng)
        img1_B, img2_B = self.color_transform(img1_B, img2_B, rng=rng)
        img1_A, img2_A = self.eraser_transform(img1_A, img2_A, rng=rng)
        img1_A, img2_A, flow, valid = self.spatial_transform(
            img1_A, img2_A, flow, valid, rng=rng)
        return tuple(np.ascontiguousarray(a) for a in
                     (img1_A, img2_A, flow, valid, img1_B, img2_B))
