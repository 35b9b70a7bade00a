"""Minimal dependency-free PNG writer (stdlib zlib only).

Replaces the reference's interactive ``pixels``/wgpu framebuffer blit
(src/main.rs:92-97) as the output path: an accelerator host has no window, so
renders land in PNG files.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def png_bytes(image: np.ndarray) -> bytes:
    """Encode an (H, W, 3) or (H, W, 4) uint8 image as PNG bytes."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"expected uint8 image, got {image.dtype}")
    if image.ndim != 3 or image.shape[2] not in (3, 4):
        raise ValueError(f"expected (H, W, 3|4) image, got {image.shape}")
    h, w, c = image.shape
    color_type = 2 if c == 3 else 6
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    # filter byte 0 (None) per scanline
    raw = b"".join(b"\x00" + image[y].tobytes() for y in range(h))
    return (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(raw, 6))
        + _chunk(b"IEND", b"")
    )


def write_png(path: str, image: np.ndarray) -> None:
    """Write an (H, W, 3) or (H, W, 4) uint8 image to ``path``."""
    with open(path, "wb") as f:
        f.write(png_bytes(image))


def read_png(path: str) -> np.ndarray:
    """Minimal reader for PNGs written by :func:`write_png` (8-bit RGB/RGBA,
    no interlace, filter 0).  For round-tripping tests and goldens."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos = 8
    w = h = c = None
    idat = b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, depth, color_type, _, _, interlace = struct.unpack(
                ">IIBBBBB", payload
            )
            if depth != 8 or interlace != 0 or color_type not in (2, 6):
                raise ValueError("unsupported PNG flavor")
            c = 3 if color_type == 2 else 4
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    raw = zlib.decompress(idat)
    stride = w * c + 1
    rows = []
    prev = np.zeros(w * c, np.uint8)
    for y in range(h):
        line = raw[y * stride : (y + 1) * stride]
        filt, body = line[0], np.frombuffer(line[1:], np.uint8)
        if filt == 0:
            row = body.copy()
        elif filt == 2:  # Up
            row = (body.astype(np.int32) + prev).astype(np.uint8)
        else:
            raise ValueError(f"unsupported PNG filter {filt}")
        rows.append(row)
        prev = row
    return np.stack(rows).reshape(h, w, c)
