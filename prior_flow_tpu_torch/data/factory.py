"""Config-driven multi-dataset loader factory (counterpart of
``prior_flow_tpu/data/factory.py``): a ``DataConfig`` selects the family
(360° or perspective), the dataset names, scene, split and augmentation,
builds each dataset from the same registries, concatenates them, and
divides the global batch by the number of data-parallel shards.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from . import datasets as ds
from .loader import DataLoader


@dataclass
class DataConfig:
    """The fields of ``prior_flow_tpu/data/factory.py::DataConfig``."""

    type: str = "360flow"            # '360flow' | 'perspective'
    name: Sequence[str] = ("MPFDataset",)
    scene: Optional[str] = None
    split: str = "train"
    aug_params: Optional[Dict[str, Any]] = field(default_factory=dict)
    batch_size: int = 4
    num_shards: int = 1              # data-parallel divisor ("num_gpu")
    shuffle: bool = True
    num_workers: int = 4
    drop_last: bool = True
    roots: Dict[str, str] = field(default_factory=dict)


_REGISTRY_360 = {
    "Flow360": ds.Flow360,
    "FlowScape": ds.FlowScape,
    "MPFDataset": ds.MPFDataset,
    "OmniFlowNet": ds.OmniFlowNetDataset,
    "OmniPhotos": ds.OmniPhotos,
    "ODVista": ds.ODVista,
    "PanoVOS": ds.PanoVOS,
}

_REGISTRY_PERSP = {
    "MpiSintel": ds.MpiSintel,
    "FlyingChairs": ds.FlyingChairs,
    "FlyingThings3D": ds.FlyingThings3D,
    "KITTI": ds.KITTI,
    "KITTI12": ds.KITTI12,
    "HD1K": ds.HD1K,
}


class ConcatDataset:
    """Concatenation of indexable datasets, indexed modulo its length. It
    has no ``set_epoch``, as in the JAX package, so its parts keep their
    epoch-0 augmentation draws."""

    def __init__(self, parts: List):
        self.parts = parts
        self._offsets = []
        total = 0
        for p in parts:
            self._offsets.append(total)
            total += len(p)
        self._total = total

    def __len__(self):
        return self._total

    def __getitem__(self, index):
        index = int(index) % self._total
        for part, off in zip(reversed(self.parts),
                             reversed(self._offsets)):
            if index >= off:
                return part[index - off]
        raise IndexError(index)


def build_dataset(cfg: DataConfig):
    registry = _REGISTRY_360 if cfg.type == "360flow" else _REGISTRY_PERSP
    parts = []
    for name in ([cfg.name] if isinstance(cfg.name, str) else cfg.name):
        cls = registry[name]
        kw: Dict[str, Any] = {}
        if cfg.aug_params is not None and cfg.split == "train":
            kw["aug_params"] = dict(cfg.aug_params)
        if name in cfg.roots:
            kw["root"] = cfg.roots[name]
        if cfg.scene is not None and name in ("FlowScape", "MPFDataset",
                                              "OmniFlowNet"):
            kw["scene"] = cfg.scene
        if name not in ("OmniPhotos", "OmniFlowNet", "HD1K",
                        "FlyingThings3D"):
            kw["split"] = cfg.split
        parts.append(cls(**kw))
    return parts[0] if len(parts) == 1 else ConcatDataset(parts)


def build_dataloader(cfg: DataConfig) -> DataLoader:
    dataset = build_dataset(cfg)
    per_shard = max(cfg.batch_size // max(cfg.num_shards, 1), 1)
    return DataLoader(dataset, batch_size=per_shard, shuffle=cfg.shuffle,
                      num_workers=cfg.num_workers, drop_last=cfg.drop_last)
