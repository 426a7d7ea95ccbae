"""Dataset index builders and sample readers (counterpart of
``prior_flow_tpu/data/datasets.py``).

Each dataset is an indexable ``torch.utils.data.Dataset`` yielding the JAX
package's numpy tuples: ``(img1, img2, flow, valid)`` (HWC float32 images
in [0, 255], (H, W, 2) flow, (H, W) valid), or ``(img1, img2,
extra_info)`` for test-only samples. The semantics are the JAX module's:

- the 360° datasets wrap horizontal flow into [-W/2, W/2);
- MPFDataset pairs frames in reversed order, because its ground truth is
  backward flow;
- the directory layouts and scene filters of every family;
- with ``aug_params`` a sample is augmented (``data/augmentor.py``) from a
  RandomState keyed by (``aug_seed``, epoch, index), so it does not depend
  on which loader worker reads it; the loader passes the epoch
  (``data/loader.py``).

``fetch_dataset`` and ``fetch_dataloader`` build a training stage's
dataset and loader (``prior_flow_tpu/data/datasets.py:425-447``).
"""

from __future__ import annotations

import logging
import os
import os.path as osp
from glob import glob
from typing import List, Optional

import numpy as np
from torch.utils.data import Dataset

from . import frame_utils
from .augmentor import (FlowAugmentor, FlowAugmentor360, SparseFlowAugmentor,
                        SparseFlowAugmentor360)

log = logging.getLogger(__name__)


class FlowDataset(Dataset):
    """Base: perspective flow dataset
    (``prior_flow_tpu/data/datasets.py:41``)."""

    sparse = False
    wrap_u = False  # 360° subclasses wrap horizontal flow

    def __init__(self, aug_params=None, sparse=False, root=None):
        self.sparse = sparse
        self.augmentor = None
        if aug_params is not None:
            self.augmentor = (SparseFlowAugmentor(**aug_params) if sparse
                              else FlowAugmentor(**aug_params))
        self.is_test = False
        self.flow_list: List[str] = []
        self.image_list: List[List[str]] = []
        self.extra_info: List = []
        self.root = root
        self.aug_seed = 1234
        self._epoch = 0

    def set_epoch(self, epoch: int):
        """The augmentation epoch: a later visit to an index draws fresh
        augmentations."""
        self._epoch = int(epoch)

    def _sample_rng(self, index: int):
        """The RandomState of one (epoch, index) sample
        (``prior_flow_tpu/data/datasets.py:68``)."""
        ss = np.random.SeedSequence([self.aug_seed, self._epoch, int(index)])
        return np.random.RandomState(ss.generate_state(4))

    def _read_images(self, index):
        img1 = np.array(frame_utils.read_gen(self.image_list[index][0])).astype(np.uint8)
        img2 = np.array(frame_utils.read_gen(self.image_list[index][1])).astype(np.uint8)
        if img1.ndim == 2:  # grayscale
            img1 = np.tile(img1[..., None], (1, 1, 3))
            img2 = np.tile(img2[..., None], (1, 1, 3))
        else:
            img1 = img1[..., :3]
            img2 = img2[..., :3]
        return img1, img2

    def __getitem__(self, index):
        if self.is_test:
            img1, img2 = self._read_images(index)
            return (img1.astype(np.float32), img2.astype(np.float32),
                    self.extra_info[index])

        index = index % len(self.image_list)
        valid = None
        if self.sparse:
            flow, valid = frame_utils.read_flow_kitti(self.flow_list[index])
            flow = np.array(flow).astype(np.float32)
            if self.wrap_u:
                _, W, _ = flow.shape
                flow[:, :, 0] = (flow[:, :, 0] + W / 2) % W - W / 2
        elif self.flow_list[index].endswith(".flo"):
            # the native decoder with its fused u-wrap where it is loaded
            from . import native
            flow = native.read_flo(self.flow_list[index], wrap_u=self.wrap_u)
        else:
            flow = np.array(
                frame_utils.read_gen(self.flow_list[index])).astype(np.float32)
            if self.wrap_u:
                _, W, _ = flow.shape
                flow[:, :, 0] = (flow[:, :, 0] + W / 2) % W - W / 2
        img1, img2 = self._read_images(index)

        if self.augmentor is not None:
            rng = self._sample_rng(index)
            if self.sparse:
                img1, img2, flow, valid = self.augmentor(img1, img2, flow,
                                                         valid, rng=rng)
            else:
                img1, img2, flow = self.augmentor(img1, img2, flow, rng=rng)

        img1 = img1.astype(np.float32)
        img2 = img2.astype(np.float32)
        if valid is None:
            valid = ((np.abs(flow[..., 0]) < 1000) &
                     (np.abs(flow[..., 1]) < 1000))
        return img1, img2, flow, valid.astype(np.float32)

    def __rmul__(self, v):
        self.flow_list = v * self.flow_list
        self.image_list = v * self.image_list
        return self

    def __len__(self):
        return len(self.image_list)


class FlowDataset360(FlowDataset):
    """Base: 360° panorama dataset; wraps horizontal flow into
    [-W/2, W/2) (``prior_flow_tpu/data/datasets.py:136``)."""

    wrap_u = True

    def __init__(self, aug_params=None, sparse=False, root=None):
        super().__init__(None, sparse=sparse, root=root)
        if aug_params is not None:
            self.augmentor = (SparseFlowAugmentor360(**aug_params) if sparse
                              else FlowAugmentor360(**aug_params))


# ---------------------------------------------------------------------------
# 360° datasets
# ---------------------------------------------------------------------------

class Flow360(FlowDataset360):
    """2022_ECCV_SLOF FLOW360 (``prior_flow_tpu/data/datasets.py:155``)."""

    def __init__(self, aug_params=None, split="train",
                 root="/data/datasets/FLOW360_train_test"):
        super().__init__(aug_params, root=root)
        assert split in ("train", "test")
        assert osp.isdir(root), f"missing dataset root {root}"
        root = osp.join(root, split)
        for d in sorted(glob(osp.join(root, "*"))):
            images = sorted(glob(osp.join(d, "frames/*.png")))[:-1]
            flows = sorted(glob(osp.join(d, "fflows/*.npy")))
            for i in range(len(flows) - 1):
                self.image_list += [[images[i], images[i + 1]]]
                self.flow_list += [flows[i]]
        assert len(self.image_list) == len(self.flow_list)
        log.info("Flow360 dataset from %s: %d pairs", root, len(self))


class FlowScape(FlowDataset360):
    """2023_T-ITS_PanoFlow FlowScape (``prior_flow_tpu/data/datasets.py:174``)."""

    SCENES = ("cloud", "fog", "rain", "sunny")

    def __init__(self, aug_params=None, split="train",
                 root="/data/datasets/FlowScape", scene="all"):
        super().__init__(aug_params, root=root)
        assert split in ("train", "test")
        assert scene in self.SCENES + ("all",), f"invalid scene {scene}"
        assert osp.isdir(root), f"missing dataset root {root}"
        root = osp.join(root, "Flow360", split)
        for sc in (self.SCENES if scene == "all" else (scene,)):
            self._add_scene(root, sc)
        assert len(self.image_list) == len(self.flow_list)
        log.info("FlowScape dataset from %s: %d pairs", root, len(self))

    def _add_scene(self, root, scene):
        for d in sorted(os.listdir(osp.join(root, scene, "img"))):
            images = sorted(glob(osp.join(root, scene, f"img/{d}/*.jpg")))
            flows = sorted(glob(osp.join(root, scene, f"flow/{d}/*.flo")))
            for i in range(len(images) - 1):
                self.image_list += [[images[i], images[i + 1]]]
                self.flow_list += [flows[i]]


class MPFDataset(FlowDataset360):
    """2022_ECCV_MPF EFT/City (``prior_flow_tpu/data/datasets.py:200``).

    NOTE the reversed pair order: the released ground truth is backward
    flow, so (frame[i+1], frame[i]) is paired with flow[i+1].
    """

    _SPLIT_DIRS = {
        "City": {"train": "City_2000_r", "val": "City_200_r", "test": "City_100_r"},
        "EFT": {"train": "EFTs_Car2000", "val": "EFTs_Car200", "test": "EFTs_Car100"},
    }

    def __init__(self, aug_params=None, split="train",
                 root="/data/datasets/ECCV2022MPF-net_dataset", scene="all"):
        super().__init__(aug_params, root=root)
        assert split in ("train", "val", "test")
        assert scene in ("EFT", "City", "all")
        assert osp.isdir(root), f"missing dataset root {root}"
        for sc in (("EFT", "City") if scene == "all" else (scene,)):
            self._add(root, sc, split)
        log.info("MPFDataset from %s %s: %d pairs", root, scene, len(self))

    def _add(self, root, scene, split):
        d = osp.join(root, self._SPLIT_DIRS[scene][split])
        flows = sorted(glob(osp.join(d, "flow", "*.flo")))
        images = sorted(glob(osp.join(d, "image", "*.png")))
        for i in range(len(images) - 1):  # backward-flow pair order
            self.image_list += [[images[i + 1], images[i]]]
            self.flow_list += [flows[i + 1]]


class OmniFlowNetDataset(FlowDataset360):
    """2020_ICPR_OmniFlowNet (``prior_flow_tpu/data/datasets.py:232``)."""

    SCENES = ("CartoonTree", "Forest", "LowPolyModels")

    def __init__(self, aug_params=None,
                 root="/data/datasets/OMNIFLOWNET_DATASET", scene="all"):
        super().__init__(aug_params, root=root)
        assert osp.isdir(root), f"missing dataset root {root}"
        assert scene in self.SCENES + ("all",)
        for sc in (self.SCENES if scene == "all" else (scene,)):
            for d in sorted(glob(osp.join(root, sc, "*"))):
                images = sorted(glob(osp.join(d, "images/*.png")))
                flows = sorted(glob(osp.join(d, "ground_truth/*.flo")))
                for i in range(len(images) - 1):
                    self.image_list += [[images[i], images[i + 1]]]
                    self.flow_list += [flows[i]]
        log.info("OmniFlowNet dataset from %s: %d pairs", root, len(self))


class OmniPhotos(FlowDataset360):
    """Visualisation-only dataset (``prior_flow_tpu/data/datasets.py:252``)."""

    def __init__(self, aug_params=None, root="/data/datasets/OmniPhotos"):
        super().__init__(aug_params, root=root)
        assert osp.isdir(root), f"missing dataset root {root}"
        self.is_test = True
        for scene in sorted(glob(osp.join(root, "*"))):
            images = sorted(glob(osp.join(scene, "Input/*.jpg")))
            for i in range(len(images) - 1):
                self.image_list += [[images[i], images[i + 1]]]
                self.extra_info += [images[i]]
        log.info("OmniPhotos dataset from %s: %d pairs", root, len(self))


class ODVista(FlowDataset360):
    """ODVista panoramic video (``prior_flow_tpu/data/datasets.py:267``)."""

    def __init__(self, aug_params=None, split="train",
                 root="/data/datasets/ODVista", resolution="H"):
        super().__init__(aug_params, root=root)
        assert split in ("train", "test")
        assert resolution in ("H", "x2", "x4")
        assert osp.isdir(root), f"missing dataset root {root}"
        self.is_test = True
        root = osp.join(root, split)
        if resolution == "H":
            self._add_subdir(osp.join(root, "HR"))
        else:
            sub = "LR_X2" if resolution == "x2" else "LR_X4"
            for group in sorted(glob(osp.join(root, sub, "*"))):
                self._add_subdir(group)
        log.info("ODVista dataset from %s: %d pairs", root, len(self))

    def _add_subdir(self, root):
        for subdir in sorted(glob(osp.join(root, "*"))):
            images = sorted(glob(osp.join(subdir, "*.png")))
            for i in range(len(images) - 1):
                self.image_list += [[images[i], images[i + 1]]]
                self.extra_info += [images[i]]


class PanoVOS(FlowDataset360):
    """PanoVOS panoramic video (``prior_flow_tpu/data/datasets.py:294``)."""

    def __init__(self, aug_params=None, split="train",
                 root="/data/datasets/PanoVOS"):
        super().__init__(aug_params, root=root)
        assert split in ("train", "test", "val")
        assert osp.isdir(root), f"missing dataset root {root}"
        self.is_test = True
        root = osp.join(root, split)
        for subdir in sorted(glob(osp.join(root, "JPEGImages", "*"))):
            images = sorted(glob(osp.join(subdir, "*.jpg")))
            for i in range(len(images) - 1):
                self.image_list += [[images[i], images[i + 1]]]
                self.extra_info += [images[i]]
        log.info("PanoVOS dataset from %s: %d pairs", root, len(self))


# ---------------------------------------------------------------------------
# perspective (legacy RAFT) datasets, prior_flow_tpu/data/datasets.py:316-420
# ---------------------------------------------------------------------------

class MpiSintel(FlowDataset):
    def __init__(self, aug_params=None, split="training",
                 root="/data/datasets/MPI-Sintel-complete/", dstype="clean"):
        super().__init__(aug_params)
        flow_root = osp.join(root, split, "flow")
        image_root = osp.join(root, split, dstype)
        if split == "test":
            self.is_test = True
        for scene in os.listdir(image_root):
            image_list = sorted(glob(osp.join(image_root, scene, "*.png")))
            for i in range(len(image_list) - 1):
                self.image_list += [[image_list[i], image_list[i + 1]]]
                self.extra_info += [(scene, i)]
            if split != "test":
                self.flow_list += sorted(glob(osp.join(flow_root, scene, "*.flo")))


class FlyingChairs(FlowDataset):
    def __init__(self, aug_params=None, split="train",
                 root="/data/datasets/FlyingChairs_release/data/",
                 split_file="chairs_split.txt"):
        super().__init__(aug_params)
        images = sorted(glob(osp.join(root, "*.ppm")))
        flows = sorted(glob(osp.join(root, "*.flo")))
        assert len(images) // 2 == len(flows)
        split_list = np.loadtxt(split_file, dtype=np.int32)
        for i in range(len(flows)):
            xid = split_list[i]
            if (split == "training" and xid == 1) or \
               (split == "validation" and xid == 2):
                self.flow_list += [flows[i]]
                self.image_list += [[images[2 * i], images[2 * i + 1]]]


class FlyingThings3D(FlowDataset):
    def __init__(self, aug_params=None,
                 root="/data/datasets/Flyingthings/", dstype="frames_cleanpass"):
        super().__init__(aug_params)
        for cam in ("left",):
            for direction in ("into_future", "into_past"):
                image_dirs = sorted(glob(osp.join(root, dstype, "TRAIN/*/*")))
                image_dirs = sorted(osp.join(f, cam) for f in image_dirs)
                flow_dirs = sorted(glob(osp.join(root, "optical_flow/TRAIN/*/*")))
                flow_dirs = sorted(osp.join(f, direction, cam) for f in flow_dirs)
                for idir, fdir in zip(image_dirs, flow_dirs):
                    images = sorted(glob(osp.join(idir, "*.png")))
                    flows = sorted(glob(osp.join(fdir, "*.pfm")))
                    for i in range(len(flows) - 1):
                        if direction == "into_future":
                            self.image_list += [[images[i], images[i + 1]]]
                            self.flow_list += [flows[i]]
                        else:
                            self.image_list += [[images[i + 1], images[i]]]
                            self.flow_list += [flows[i + 1]]


class KITTI(FlowDataset):
    def __init__(self, aug_params=None, split="training",
                 root="/data/datasets/Kitti2015"):
        super().__init__(aug_params, sparse=True)
        if split == "testing":
            self.is_test = True
        root = osp.join(root, split)
        images1 = sorted(glob(osp.join(root, "image_2/*_10.png")))
        images2 = sorted(glob(osp.join(root, "image_2/*_11.png")))
        for img1, img2 in zip(images1, images2):
            self.extra_info += [[img1.split("/")[-1]]]
            self.image_list += [[img1, img2]]
        if split == "training":
            self.flow_list = sorted(glob(osp.join(root, "flow_occ/*_10.png")))


class KITTI12(FlowDataset):
    def __init__(self, aug_params=None, split="training",
                 root="/data/datasets/Kitti2012/"):
        super().__init__(aug_params, sparse=True)
        if split == "testing":
            self.is_test = True
        root = osp.join(root, split)
        images1 = sorted(glob(osp.join(root, "colored_0/*_10.png")))
        images2 = sorted(glob(osp.join(root, "colored_0/*_11.png")))
        for img1, img2 in zip(images1, images2):
            self.extra_info += [[img1.split("/")[-1]]]
            self.image_list += [[img1, img2]]
        if split == "training":
            self.flow_list = sorted(glob(osp.join(root, "flow_occ/*_10.png")))


class HD1K(FlowDataset):
    def __init__(self, aug_params=None, root="/data/datasets/hd1k_full_package/"):
        super().__init__(aug_params, sparse=True)
        seq_ix = 0
        while True:
            flows = sorted(glob(osp.join(root, "hd1k_flow_gt",
                                         "flow_occ/%06d_*.png" % seq_ix)))
            images = sorted(glob(osp.join(root, "hd1k_input",
                                          "image_2/%06d_*.png" % seq_ix)))
            if not flows:
                break
            for i in range(len(flows) - 1):
                self.flow_list += [flows[i]]
                self.image_list += [[images[i], images[i + 1]]]
            seq_ix += 1


# ---------------------------------------------------------------------------
# training stage -> dataset and loader (prior_flow_tpu/data/datasets.py:425)
# ---------------------------------------------------------------------------

def fetch_dataset(stage: str, data_root: Optional[str] = None):
    """The training dataset of a stage, City, EFT or FlowScape, augmented
    with ``do_flip=False``."""
    aug_params = {"do_flip": False}
    kw = {"root": data_root} if data_root else {}
    if stage == "City":
        return MPFDataset(aug_params, split="train", scene="City", **kw)
    if stage == "EFT":
        return MPFDataset(aug_params, split="train", scene="EFT", **kw)
    if stage == "FlowScape":
        return FlowScape(aug_params, split="train", **kw)
    raise ValueError(f"unknown training stage {stage!r}")


def fetch_dataloader(args):
    """The shuffling batch loader of ``args.stage`` (``args.batch_size``,
    ``args.data_root``), four worker processes, the last short batch
    dropped."""
    from .loader import DataLoader

    dataset = fetch_dataset(args.stage, getattr(args, "data_root", None))
    print(f"Training with {len(dataset)} image pairs")
    return DataLoader(dataset, batch_size=args.batch_size, shuffle=True,
                      num_workers=4, drop_last=True)
