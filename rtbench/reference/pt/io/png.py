"""Minimal PNG codec (pure stdlib + numpy).

Carried over unchanged from raytracingrenderer_tpu/io/png.py.  Replaces
the vendored stb_image / stb_image_write usage of the RTBase renderer
(Imaging.h:16-130, Renderer.h:891-898) for LDR
texture input (the reader alone).  Supports non-interlaced 8/16-bit
grayscale / RGB / palette / grayscale+alpha / RGBA images, which covers
every texture shipped with the reference scenes.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"

# channels per pixel for PNG color types
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def read_png(path: str) -> np.ndarray:
    """Read a PNG file into a (H, W, C) uint8/uint16 array (C in 1..4)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    idat = []
    palette = None
    trns = None
    width = height = bitdepth = ctype = None
    interlace = 0
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctag = data[pos + 4:pos + 8]
        chunk = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctag == b"IHDR":
            width, height, bitdepth, ctype, _, _, interlace = struct.unpack(
                ">IIBBBBB", chunk)
        elif ctag == b"PLTE":
            palette = np.frombuffer(chunk, np.uint8).reshape(-1, 3)
        elif ctag == b"tRNS":
            trns = np.frombuffer(chunk, np.uint8)
        elif ctag == b"IDAT":
            idat.append(chunk)
        elif ctag == b"IEND":
            break
    if width is None:
        raise ValueError(f"{path}: missing IHDR")
    if interlace != 0:
        raise ValueError(f"{path}: interlaced PNG not supported")
    if bitdepth not in (8, 16):
        raise ValueError(f"{path}: bitdepth {bitdepth} not supported")
    raw = zlib.decompress(b"".join(idat))
    nch = _CHANNELS[ctype]
    bpp = nch * (bitdepth // 8)  # bytes per pixel
    stride = width * bpp
    out = np.empty((height, stride), np.uint8)
    raw = np.frombuffer(raw, np.uint8)
    # Unfilter scanline by scanline (sequential data dependency).
    offs = 0
    prev = np.zeros(stride, np.uint16)
    for y in range(height):
        ftype = raw[offs]
        line = raw[offs + 1:offs + 1 + stride].astype(np.uint16)
        offs += 1 + stride
        if ftype == 0:
            cur = line
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        else:
            cur = np.empty(stride, np.uint16)
            if ftype == 1:  # Sub
                cur[:bpp] = line[:bpp]
                for i in range(bpp, stride):
                    cur[i] = (line[i] + cur[i - bpp]) & 0xFF
            elif ftype == 3:  # Average
                for i in range(stride):
                    a = cur[i - bpp] if i >= bpp else 0
                    cur[i] = (line[i] + ((a + prev[i]) >> 1)) & 0xFF
            elif ftype == 4:  # Paeth
                for i in range(stride):
                    a = int(cur[i - bpp]) if i >= bpp else 0
                    b = int(prev[i])
                    c = int(prev[i - bpp]) if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                    cur[i] = (line[i] + pred) & 0xFF
            else:
                raise ValueError(f"{path}: bad filter {ftype}")
        out[y] = cur.astype(np.uint8)
        prev = cur
    if bitdepth == 16:
        img = out.reshape(height, width, nch, 2)
        img = (img[..., 0].astype(np.uint16) << 8) | img[..., 1]
    else:
        img = out.reshape(height, width, nch)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette image without PLTE")
        rgb = palette[img[..., 0]]
        if trns is not None:
            alpha = np.full((height, width, 1), 255, np.uint8)
            n = min(len(trns), palette.shape[0])
            alpha[..., 0] = np.where(img[..., 0] < n,
                                     trns[np.minimum(img[..., 0], n - 1)], 255)
            img = np.concatenate([rgb, alpha], axis=-1)
        else:
            img = rgb
    return img


def read_png_float(path: str) -> np.ndarray:
    """Read PNG as float32 in [0,1], always returning (H, W, C)."""
    img = read_png(path)
    scale = 65535.0 if img.dtype == np.uint16 else 255.0
    return img.astype(np.float32) / scale
