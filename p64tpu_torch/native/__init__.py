"""The C++ bit-I/O engine (serialize, parse), built from the port's copy
`csrc/bitio.cpp` by `kernels._build.build_native`, with the decode's level
packer (`csrc/levels_pack.cpp`, `kernels._build.build_levels_pack`), and
the batch serializer built from `csrc/serialize_batch.cpp` by
`kernels._build.build_batch_serializer`, all bound with ctypes."""

from .binding import (PACKED_KEYS, BatchSerializer, NativeBitIO, load,
                      load_batch)

__all__ = ["PACKED_KEYS", "BatchSerializer", "NativeBitIO", "load",
           "load_batch"]
