"""Native (C++) host code of the port, compiled on first use: the dense
collate fill over a packed graph store.  ``ISUBGVQA_NATIVE=0`` selects
the Python fill; a failed build raises."""

from .build import NativeBuildError, build_and_load, native_disabled
from .collate import PackedGraphStore, load_collate_lib

__all__ = ["NativeBuildError", "build_and_load", "native_disabled",
           "PackedGraphStore", "load_collate_lib"]
