"""Encoders, update blocks and shared layers (NCHW torch modules)."""

from .encoder import BasicEncoder, ResidualBlock
from .layers import FrozenBatchNorm, InstanceNorm, conv
from .update import (BasicMotionEncoder, BasicMultiMotionEncoder,
                     BasicMultiUpdateBlock, BasicUpdateBlock, FlowHead,
                     SepConvGRU)

__all__ = ["BasicEncoder", "ResidualBlock", "FrozenBatchNorm", "InstanceNorm",
           "conv", "BasicMotionEncoder", "BasicMultiMotionEncoder",
           "BasicMultiUpdateBlock", "BasicUpdateBlock", "FlowHead",
           "SepConvGRU"]
