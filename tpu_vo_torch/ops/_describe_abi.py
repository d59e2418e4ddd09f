"""The constants that the describe kernel takes by value
(csrc/describe.cu `tvo::DescribeConsts`, same fields in the same order).
A leaf module, so that the kernels' loader (ops/_build) can declare the
launcher's arguments without importing the features it serves; the
values are ops/describe.consts()."""

from __future__ import annotations

import ctypes

UMAX_ROWS = 16  # the moment circle's rows |v| = 0..15 (orientation.HALF_PATCH + 1)


class DescribeConsts(ctypes.Structure):
    _fields_ = [("taps", ctypes.c_float * 7),
                ("p1", ctypes.c_float), ("p3", ctypes.c_float), ("p5", ctypes.c_float),
                ("p7", ctypes.c_float), ("eps", ctypes.c_float),
                ("deg2rad", ctypes.c_float),
                ("umax", ctypes.c_int * UMAX_ROWS)]
