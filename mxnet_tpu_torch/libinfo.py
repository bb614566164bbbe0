"""Library and version information (counterpart of
``mxnet_tpu/libinfo.py``; reference: python/mxnet/libinfo.py).

The reference locates ``libmxnet.so``. The port's native libraries are
the CUDA kernels that ``parallel/_build.py`` builds with nvcc at first
use and the RecordIO reader that ``io/native.py`` builds with g++, both
under ``mxnet_tpu_torch/_build/``: :func:`find_lib_path` lists those of
the current sources that exist (none before the first build)."""
from __future__ import annotations

import os

__all__ = ["find_lib_path", "find_include_path", "__version__"]

__version__ = "0.1.0"


def find_lib_path():
    """Paths of the built native libraries of the current sources."""
    from .io.native import lib_path
    from .parallel._build import SOURCES, _lib_path
    paths = [_lib_path(name)[1] for name in SOURCES] + [lib_path()]
    return [p for p in paths if os.path.exists(p)]


def find_include_path():
    """The kernel sources' directory (each ``.cu`` file has a plain C
    entry point; no separate headers are installed)."""
    here = os.path.dirname(os.path.abspath(__file__))
    inc = os.path.join(here, "parallel", "csrc")
    return inc if os.path.isdir(inc) else ""
