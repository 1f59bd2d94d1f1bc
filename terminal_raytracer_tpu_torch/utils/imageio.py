"""Image-file IO (PPM and PNG) — the reference has no image IO at all
(SURVEY.md §5.4: "no image-file output"); these exist for golden-image
tests, benchmarks, offline rendering, and texture loading. PNG is read and
written with stdlib zlib only (no imaging deps)."""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def write_ppm(path, rgb: np.ndarray) -> None:
    """Binary PPM (P6) from an [H, W, 3] uint8 array."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    with open(Path(path), "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(rgb.tobytes())


def read_ppm(path) -> np.ndarray:
    data = Path(path).read_bytes()
    if not data.startswith(b"P6"):
        raise ValueError("not a binary PPM (P6)")
    # header: magic, width, height, maxval — whitespace separated, then raster
    fields = []
    i = 2
    while len(fields) < 3:
        while i < len(data) and data[i : i + 1].isspace():
            i += 1
        if data[i : i + 1] == b"#":
            while data[i : i + 1] != b"\n":
                i += 1
            continue
        j = i
        while not data[j : j + 1].isspace():
            j += 1
        fields.append(int(data[i:j]))
        i = j
    i += 1  # single whitespace after maxval
    w, h, _maxval = fields
    return np.frombuffer(data[i : i + w * h * 3], np.uint8).reshape(h, w, 3)


def write_png(path, rgb: np.ndarray) -> None:
    """Minimal 8-bit RGB PNG writer (stdlib zlib only)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload))
            + tag
            + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit truecolor
    # filter byte 0 (None) per scanline
    raster = np.concatenate(
        [np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1
    ).tobytes()
    idat = zlib.compress(raster, 6)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", idat)
        + chunk(b"IEND", b"")
    )
    Path(path).write_bytes(png)


def read_png(path) -> np.ndarray:
    """Minimal 8-bit PNG reader (stdlib zlib only): truecolor (RGB) and
    truecolor-alpha (RGBA, alpha dropped), non-interlaced, any scanline
    filter (None/Sub/Up/Average/Paeth). Covers what write_png emits and
    the overwhelming majority of texture PNGs; anything fancier
    (palette, 16-bit, grayscale, interlace) raises a clear error.
    Returns [H, W, 3] uint8."""
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    i = 8
    w = h = None
    channels = 0
    idat = b""
    while i < len(data):
        (length,) = struct.unpack(">I", data[i:i + 4])
        tag = data[i + 4:i + 8]
        payload = data[i + 8:i + 8 + length]
        i += 12 + length
        if tag == b"IHDR":
            w, h, depth, color, _comp, _filt, interlace = struct.unpack(
                ">IIBBBBB", payload)
            if depth != 8:
                raise ValueError(f"unsupported PNG bit depth {depth} "
                                 f"(only 8-bit supported)")
            if color not in (2, 6):
                raise ValueError(f"unsupported PNG color type {color} "
                                 f"(only RGB/RGBA truecolor supported)")
            if interlace:
                raise ValueError("interlaced PNGs are not supported")
            channels = 3 if color == 2 else 4
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    if w is None:
        raise ValueError("PNG has no IHDR chunk")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    stride = w * channels
    if raw.size != h * (stride + 1):
        raise ValueError("PNG raster size mismatch")
    raw = raw.reshape(h, stride + 1)
    filters, lines = raw[:, 0], raw[:, 1:].astype(np.int32)
    out = np.zeros((h, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    bpp = channels
    for y in range(h):
        f, line = int(filters[y]), lines[y]
        if f == 0:  # None
            cur = line.copy()
        elif f == 2:  # Up
            cur = (line + prev) & 255
        elif f in (1, 3, 4):  # Sub / Average / Paeth: left-sequential
            cur = np.empty(stride, np.int32)
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                if f == 1:
                    rec = line[x] + a
                elif f == 3:
                    rec = line[x] + ((a + b) >> 1)
                else:
                    c = prev[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (
                        b if pb <= pc else c)
                    rec = line[x] + pred
                cur[x] = rec & 255
        else:
            raise ValueError(f"unknown PNG filter type {f}")
        out[y] = cur
        prev = cur
    rgb = out.astype(np.uint8).reshape(h, w, channels)
    return np.ascontiguousarray(rgb[:, :, :3])
