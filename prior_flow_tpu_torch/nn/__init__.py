"""Encoders, update blocks and shared layers (NCHW torch modules)."""

from .encoder import (BasicEncoder, BottleneckBlock, ResidualBlock,
                      SmallEncoder)
from .layers import BatchNorm, FrozenBatchNorm, GroupNorm, InstanceNorm, conv
from .update import (BasicMotionEncoder, BasicMultiMotionEncoder,
                     BasicMultiUpdateBlock, BasicUpdateBlock, ConvGRU,
                     FlowHead, SepConvGRU, SmallMotionEncoder,
                     SmallUpdateBlock)

__all__ = ["BasicEncoder", "BottleneckBlock", "ResidualBlock", "SmallEncoder",
           "BatchNorm", "FrozenBatchNorm", "GroupNorm", "InstanceNorm",
           "conv", "BasicMotionEncoder", "BasicMultiMotionEncoder",
           "BasicMultiUpdateBlock", "BasicUpdateBlock", "ConvGRU", "FlowHead",
           "SepConvGRU", "SmallMotionEncoder", "SmallUpdateBlock"]
