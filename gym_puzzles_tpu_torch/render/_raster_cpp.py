"""ctypes binding of the C++ rasterizer core (``csrc/_raster.cpp``).

The library is built at first use with ``g++ -O3 -fPIC -shared -std=c++17
-march=native`` into ``_build/`` beside the package, cached by a hash of the
source, the flags and the CPU that ``-march=native`` resolves to (a build
directory copied to another host is not reused there).  A failed build
raises with the compiler's output: the renderer never falls back to numpy
on its own.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import threading

import numpy as np

from gym_puzzles_tpu_torch.engine import _cuda_build as cb

SOURCE = cb.CSRC / "_raster.cpp"
FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-march=native")

_lib = None
_lock = threading.Lock()


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host rasterizer is built with g++")
    return gxx


def build():
    """Build the library unless it exists -> (path, compiler output)."""
    gxx = _gxx()
    # what -march=native means on this CPU, so that the cache key names it
    target = subprocess.run([gxx, "-march=native", "-Q", "--help=target"], capture_output=True,
                            text=True, check=True).stdout
    return cb.build_library("raster", [gxx, *FLAGS], [SOURCE],
                            " ".join(FLAGS) + "\n" + target)


def lib():
    """The loaded library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            path, _log = build()
            so = ctypes.CDLL(str(path))
            vp, ci, cf, cu8 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint8
            so.gpt_fill_polygon.argtypes = [vp, ci, ci, vp, ci, cu8, cu8, cu8]
            so.gpt_fill_circle.argtypes = [vp, ci, ci, cf, cf, cf, cu8, cu8, cu8, ci, cf]
            so.gpt_draw_line.argtypes = [vp, ci, ci, cf, cf, cf, cf, cu8, cu8, cu8, cf]
            for fn in (so.gpt_fill_polygon, so.gpt_fill_circle, so.gpt_draw_line):
                fn.restype = None
            _lib = so
    return _lib


def _img_args(img):
    if not (img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3
            and img.flags.c_contiguous):
        raise ValueError("expected a C-contiguous uint8 [h, w, 3] image")
    h, w, _ = img.shape
    return img.ctypes.data, h, w


def fill_polygon(img, verts, color):
    """Fill the convex polygon ``verts`` [N, 2] (float pixels, counter-clockwise
    in image coordinates) with ``color`` in place."""
    verts = np.ascontiguousarray(verts, np.float32)
    lib().gpt_fill_polygon(*_img_args(img), verts.ctypes.data, len(verts), *color)


def fill_circle(img, cx, cy, r, color, filled=True, thickness=2.0):
    """A disc (or, with ``filled`` off, a ring of half-width ``thickness``)."""
    lib().gpt_fill_circle(*_img_args(img), cx, cy, r, *color, int(filled), thickness)


def draw_line(img, ax, ay, bx, by, color, thickness=1.5):
    lib().gpt_draw_line(*_img_args(img), ax, ay, bx, by, *color, thickness)
