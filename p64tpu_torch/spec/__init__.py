"""H.261 normative layer: constants, VLC tables, zigzag order, compiled LUTs."""

from . import constants, luts, tables, zigzag  # noqa: F401
