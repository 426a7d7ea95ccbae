"""ERP geometry: coordinate algebra and host-built rotation grids."""

from . import erp, grids, rotation
from .grids import (RotationGrids, identity_grid, identity_grid_on,
                    rotation_grids, sample_grid)

__all__ = ["erp", "grids", "rotation", "RotationGrids", "identity_grid",
           "identity_grid_on", "rotation_grids", "sample_grid"]
