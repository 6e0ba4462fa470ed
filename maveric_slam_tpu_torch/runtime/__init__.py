"""Native C++ host runtime (feature pool, LCD scoring) with ctypes bindings,
built at first use (see pool.py)."""

from .pool import FeaturePool, lcd_intersect  # noqa: F401
