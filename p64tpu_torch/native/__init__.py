"""The C++ bit-I/O engine (serialize, parse), built from the JAX package's
`p64tpu/native/bitio.cpp` and bound with ctypes."""

from .binding import NativeBitIO, load

__all__ = ["NativeBitIO", "load"]
