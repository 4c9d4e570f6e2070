"""The standard-library PNG codec (`utils/png.py`) used by `render`,
`serve` and the golden gate."""

import struct
import zlib

import numpy as np
import pytest

from wgpu_3dgs_viewer_app_tpu.utils.png import decode_png, encode_png, read_png, to_u8, write_png


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_roundtrip(channels, tmp_path):
    img = np.random.default_rng(channels).integers(0, 256, (37, 53, channels), np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    np.testing.assert_array_equal(read_png(path), img)


def _png_with_filters(img):
    """Hand-built PNG whose rows cycle through filter types 0-4."""
    h, w, c = img.shape
    rows = []
    prev = np.zeros(w * c, np.int64)
    for y in range(h):
        cur = img[y].reshape(-1).astype(np.int64)
        f = y % 5
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        if f == 0:
            out = cur
        elif f == 1:
            out = cur - left
        elif f == 2:
            out = cur - prev
        elif f == 3:
            out = cur - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
            out = cur - pred
        rows.append(bytes([f]) + (out % 256).astype(np.uint8).tobytes())
        prev = cur

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


def test_decodes_every_filter_type():
    img = np.random.default_rng(0).integers(0, 256, (20, 17, 3), np.uint8)
    np.testing.assert_array_equal(decode_png(_png_with_filters(img)), img)


def test_rejects_non_png_and_non_uint8():
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a")
    with pytest.raises(ValueError, match="uint8"):
        encode_png(np.zeros((2, 2, 3), np.float32))


def test_to_u8_clips():
    np.testing.assert_array_equal(to_u8(np.array([-0.5, 0.0, 0.5, 1.0, 2.0])),
                                  np.array([0, 0, 127, 255, 255], np.uint8))
