"""Native IO: threaded JPEG decode + preprocess (C++ via ctypes)."""

from .native import NativeImageLoader, native_available
