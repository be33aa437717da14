"""The C++ bit-I/O engine (serialize, parse), built from the port's copy
`csrc/bitio.cpp` by `kernels._build.build_native` and bound with ctypes."""

from .binding import NativeBitIO, load

__all__ = ["NativeBitIO", "load"]
