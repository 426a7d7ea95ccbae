"""Flow-file and image I/O (counterpart of
``prior_flow_tpu/data/frame_utils.py``): Middlebury ``.flo``, ``.pfm``,
KITTI 16-bit PNG flow and disparity, images, and the ``read_gen``
extension dispatcher, in the JAX module's formats. The flow formats are
numpy; the image codecs come from ``PIL`` or ``cv2``, imported at first
use. A reader or writer whose codec library is missing raises an
``ImportError`` that names it.
"""

from __future__ import annotations

import re
from os.path import splitext

import numpy as np

FLO_MAGIC = 202021.25


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError("cv2 (OpenCV) is required for 16-bit KITTI PNG "
                          "flow and disparity") from e
    cv2.setNumThreads(0)
    cv2.ocl.setUseOpenCL(False)
    return cv2


def _pil_image():
    """PIL's ``Image`` module, or None where PIL is not installed."""
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def read_flo(path: str) -> np.ndarray:
    """Read a Middlebury .flo file -> (H, W, 2) float32."""
    with open(path, "rb") as f:
        magic = np.frombuffer(f.read(4), np.float32)[0]
        if magic != np.float32(FLO_MAGIC):
            raise ValueError(f"{path}: bad .flo magic {magic!r}")
        w = int(np.frombuffer(f.read(4), np.int32)[0])
        h = int(np.frombuffer(f.read(4), np.int32)[0])
        data = np.frombuffer(f.read(8 * w * h), np.float32)
    return data.reshape(h, w, 2).copy()


def write_flo(path: str, flow) -> None:
    """Write (H, W, 2) flow as a Middlebury .flo file."""
    flow = np.asarray(flow)
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"flow must be (H, W, 2), got {flow.shape}")
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.float32(FLO_MAGIC).tofile(f)
        np.int32(w).tofile(f)
        np.int32(h).tofile(f)
        flow.astype(np.float32).tofile(f)


def read_pfm(path: str) -> np.ndarray:
    """Read a .pfm file -> (H, W) or (H, W, 3) float array (top-down)."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError(f"{path}: not a PFM file")
        dims = re.match(rb"^(\d+)\s(\d+)\s*$", f.readline())
        if not dims:
            raise ValueError(f"{path}: malformed PFM header")
        w, h = map(int, dims.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (h, w, 3) if color else (h, w)
    return np.flipud(data.reshape(shape)).copy()


def read_flow_kitti(path: str):
    """Read KITTI uint16-png flow -> ((H, W, 2) float32, (H, W) valid)."""
    cv2 = _cv2()
    raw = cv2.imread(path, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)
    raw = raw[:, :, ::-1].astype(np.float32)  # BGR -> RGB = (u, v, valid)
    flow, valid = raw[:, :, :2], raw[:, :, 2]
    return (flow - 2 ** 15) / 64.0, valid


def write_flow_kitti(path: str, flow) -> None:
    """Write (H, W, 2) flow as a KITTI uint16 png (valid = all ones)."""
    cv2 = _cv2()
    uv = 64.0 * np.asarray(flow) + 2 ** 15
    valid = np.ones(uv.shape[:2] + (1,), uv.dtype)
    out = np.concatenate([uv, valid], axis=-1).astype(np.uint16)
    cv2.imwrite(path, out[..., ::-1])


def read_disp_kitti(path: str):
    """Read a KITTI disparity png as a pseudo-flow ((H, W, 2), valid)."""
    cv2 = _cv2()
    disp = cv2.imread(path, cv2.IMREAD_ANYDEPTH) / 256.0
    valid = disp > 0.0
    return np.stack([-disp, np.zeros_like(disp)], -1), valid


def read_image(path: str) -> np.ndarray:
    """Read an image file -> (H, W, C) uint8 RGB (or (H, W) grayscale):
    through PIL where it is installed, else through cv2."""
    Image = _pil_image()
    if Image is not None:
        with Image.open(path) as im:
            return np.array(im)
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{path}: reading an image needs PIL or cv2, and "
                          f"neither is installed") from e
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise ValueError(f"{path}: cv2 could not read the image")
    return img[:, :, ::-1] if img.ndim == 3 else img


def write_image(path: str, img) -> None:
    """Write an (H, W, 3) RGB or (H, W) grey uint8 image, in the format the
    extension names: through PIL where it is installed, else through cv2."""
    img = np.ascontiguousarray(np.asarray(img, np.uint8))
    Image = _pil_image()
    if Image is not None:
        Image.fromarray(img).save(path)
        return
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{path}: writing an image needs PIL or cv2, and "
                          f"neither is installed") from e
    if not cv2.imwrite(path, img[:, :, ::-1] if img.ndim == 3 else img):
        raise ValueError(f"{path}: cv2 could not write the image")


def read_gen(path: str):
    """Extension-dispatch reader
    (``prior_flow_tpu/data/frame_utils.py:118``)."""
    ext = splitext(path)[-1].lower()
    if ext in (".png", ".jpeg", ".ppm", ".jpg"):
        return read_image(path)
    if ext in (".bin", ".raw", ".npy"):
        return np.load(path)
    if ext == ".flo":
        return read_flo(path).astype(np.float32)
    if ext == ".pfm":
        flow = read_pfm(path).astype(np.float32)
        return flow if flow.ndim == 2 else flow[:, :, :-1]
    return []
