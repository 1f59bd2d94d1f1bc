"""ANSI frame encoder — ``terminal_raytracer_tpu/runtime/blit.py``.

The native encoder is the port's copy of the JAX package's
``native/blit.cpp`` (``csrc/blit.cpp``), compiled with g++ at first use
into this package's build directory (``terminal_raytracer_tpu_torch/_build/``,
content-hashed). The pure-Python
encoder produces byte-identical output for hosts without g++; it is a host
encoder, not a stand-in for any device code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
from pathlib import Path
from typing import Optional

import numpy as np

from ..ops.tonemap import GLYPH_RAMP

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "blit.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

_lib = None
_lib_tried = False


def _load_native():
    """Compile (once, content-hashed) and dlopen the blitter."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    try:
        tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
        so = _BUILD_DIR / f"blit-{tag}.so"
        if not so.exists():
            _BUILD_DIR.mkdir(exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                 str(_SRC), "-o", str(tmp), "-pthread"],
                check=True, capture_output=True,
            )
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.trt_blit.restype = ctypes.c_long
        lib.trt_blit.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_long,
        ]
        lib.trt_max_row_bytes.restype = ctypes.c_long
        lib.trt_max_row_bytes.argtypes = [ctypes.c_int]
        _lib = lib
    except (OSError, subprocess.CalledProcessError) as e:
        print(f"[blit] native blitter unavailable ({e}); using the Python "
              f"encoder", file=sys.stderr)
        _lib = None
    return _lib


class Blitter:
    """Reusable frame encoder (owns the output buffer across frames)."""

    def __init__(self, height: int, width: int, full_color: bool,
                 threads: int = 0, force_python: bool = False):
        self.h, self.w = height, width
        self.full_color = full_color
        self.threads = threads if threads > 0 else (os.cpu_count() or 4)
        self._lib = None if force_python else _load_native()
        if self._lib is not None:
            cap = int(self._lib.trt_max_row_bytes(width)) * height
            self._buf = bytearray(cap)
        self._dec = [str(i).encode() for i in range(256)]
        self._ramp = [GLYPH_RAMP[i].encode() for i in range(len(GLYPH_RAMP))]

    @property
    def native(self) -> bool:
        return self._lib is not None

    def encode(self, rgb: np.ndarray, glyphs: Optional[np.ndarray]) -> bytes:
        """rgb: [H, W, 3] u8; glyphs: [H, W] u8 (ASCII mode). Returns the
        ANSI byte stream for the frame (rows end with CRLF)."""
        rgb = np.ascontiguousarray(rgb, np.uint8)
        if glyphs is None:
            glyphs = np.zeros((self.h, self.w), np.uint8)
        glyphs = np.ascontiguousarray(glyphs, np.uint8)
        if self._lib is not None:
            buf = (ctypes.c_char * len(self._buf)).from_buffer(self._buf)
            n = self._lib.trt_blit(
                rgb.ctypes.data, glyphs.ctypes.data, self.h, self.w,
                1 if self.full_color else 0, self.threads, buf, len(self._buf),
            )
            if n >= 0:
                return bytes(self._buf[:n])
        return self._encode_python(rgb, glyphs)

    def _encode_python(self, rgb: np.ndarray, glyphs: np.ndarray) -> bytes:
        dec = self._dec
        ramp = self._ramp
        block = "█".encode()
        out = bytearray()
        fc = self.full_color
        for y in range(self.h):
            row_rgb = rgb[y]
            row_g = glyphs[y]
            for x in range(self.w):
                r, g, b = row_rgb[x]
                out += b"\x1b[38;2;" + dec[r] + b";" + dec[g] + b";" + dec[b] + b"m"
                out += block if fc else ramp[min(int(row_g[x]), 67)]
                out += b"\x1b[0m"
            out += b"\r\n"
        return bytes(out)
