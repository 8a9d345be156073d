"""PNG writing: the native encoder, else PIL, else a minimal pure-python
encoder.

Replaces the reference's vendored lodepng (fb/framebuffer.cpp:109-143).
"""

import struct
import zlib

import numpy as np


def write_png(filename: str, array: np.ndarray):
    """array: [H, W] (grey) or [H, W, 3] (RGB) uint8.

    Encoder preference: the port's native zlib encoder
    (qaray_tpu_torch/native.py), then PIL, then the pure python encoder
    below.
    """
    array = np.ascontiguousarray(array.astype(np.uint8))
    from qaray_tpu_torch import native

    if native.png_write_native(filename, array):
        return
    try:
        from PIL import Image

        Image.fromarray(array).save(filename)
        return
    except ImportError:
        pass
    _write_png_native(filename, array)


def png_bytes(array: np.ndarray) -> bytes:
    """The PNG file of array ([H, W] grey or [H, W, 3] RGB uint8) as bytes,
    by the pure python encoder (the preview server sends these)."""
    array = np.ascontiguousarray(array.astype(np.uint8))
    h, w = array.shape[:2]
    color_type = 0 if array.ndim == 2 else 2
    raw = array.reshape(h, -1)
    # Filter byte 0 per scanline.
    scanlines = b"".join(b"\x00" + raw[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(scanlines, 6))
            + chunk(b"IEND", b""))


def _write_png_native(filename: str, array: np.ndarray):
    with open(filename, "wb") as f:
        f.write(png_bytes(array))
