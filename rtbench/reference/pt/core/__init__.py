from .vec import (V3, vdot, vcross, vmax, vmin, vclamp, vwhere, vlerp,
                  reflect_z)
from .frame import Frame
from . import matrix, spherical

EPSILON = 1e-4  # self-intersection offset (RTBase Geometry.h:60)

__all__ = ["V3", "vdot", "vcross", "vmax", "vmin", "vclamp", "vwhere",
           "vlerp", "reflect_z", "Frame", "matrix", "spherical", "EPSILON"]
