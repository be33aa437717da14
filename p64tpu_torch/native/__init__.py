"""The C++ bit-I/O engine (serialize, parse), built from the port's copy
`csrc/bitio.cpp` by `kernels._build.build_native`, and the batch
serializer built from `csrc/serialize_batch.cpp` by
`kernels._build.build_batch_serializer`, both bound with ctypes."""

from .binding import BatchSerializer, NativeBitIO, load, load_batch

__all__ = ["BatchSerializer", "NativeBitIO", "load", "load_batch"]
