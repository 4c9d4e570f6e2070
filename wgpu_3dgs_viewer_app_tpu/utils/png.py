"""PNG encode/decode with the standard library (zlib + struct) and numpy.

Covers what the viewer writes and reads: 8-bit greyscale, RGB and RGBA,
non-interlaced, every scanline filter type on decode.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels (8-bit samples only).
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}


def to_u8(img) -> np.ndarray:
    """Float image in [0, 1] -> uint8, clipped."""
    return np.clip(np.asarray(img, np.float32) * 255.0, 0, 255).astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))


def encode_png(arr: np.ndarray, level: int = 6) -> bytes:
    """(H, W) or (H, W, 1|3|4) uint8 -> PNG bytes (filter 0 on every row)."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        raise ValueError(f"encode_png wants uint8, got {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"encode_png: {c} channels unsupported")
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), np.ascontiguousarray(arr).reshape(h, w * c)],
        axis=1,
    )
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str, arr: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(arr))


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((h, stride), np.uint8)
    prev = bytearray(stride)
    pos = 0
    for y in range(h):
        ftype = data[pos]
        row = bytearray(data[pos + 1 : pos + 1 + stride])
        pos += 1 + stride
        if ftype == 1:  # Sub
            for i in range(bpp, stride):
                row[i] = (row[i] + row[i - bpp]) & 0xFF
        elif ftype == 2:  # Up
            row = bytearray((np.frombuffer(row, np.uint8)
                             + np.frombuffer(prev, np.uint8)).tobytes())
        elif ftype == 3:  # Average
            for i in range(stride):
                left = row[i - bpp] if i >= bpp else 0
                row[i] = (row[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            for i in range(stride):
                a = row[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                row[i] = (row[i] + pred) & 0xFF
        elif ftype != 0:
            raise ValueError(f"PNG: bad filter type {ftype} on row {y}")
        out[y] = np.frombuffer(row, np.uint8)
        prev = row
    return out


def decode_png(blob: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8 (C = 1, 2, 3 or 4)."""
    if blob[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos : pos + 4])
        tag = blob[pos + 4 : pos + 8]
        data = blob[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"PNG: unsupported depth {depth} / colour type {ctype} "
                         f"/ interlace {interlace}")
    c = _CHANNELS[ctype]
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w * c, c)
    return rows.reshape(h, w, c)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())
