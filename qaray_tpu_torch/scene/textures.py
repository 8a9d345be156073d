"""Host-side image loading (PNG via PIL, PPM-P6 natively).

Replaces the reference's lodepng/PPM loader (textures/texture.cpp:32-93).
Returns float32 HxWx3 in [0,1].
"""

from __future__ import annotations

import numpy as np


def load_ppm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    # Header: P6 <w> <h> <maxval>, tokens separated by whitespace/comments.
    tokens = []
    i = 0
    while len(tokens) < 4:
        # skip whitespace
        while i < len(data) and data[i : i + 1].isspace():
            i += 1
        if data[i : i + 1] == b"#":
            while i < len(data) and data[i : i + 1] != b"\n":
                i += 1
            continue
        j = i
        while j < len(data) and not data[j : j + 1].isspace():
            j += 1
        tokens.append(data[i:j])
        i = j
    if tokens[0] != b"P6":
        raise ValueError(f"{path}: not a P6 PPM")
    w, h, maxval = int(tokens[1]), int(tokens[2]), int(tokens[3])
    i += 1  # single whitespace after maxval
    img = np.frombuffer(data[i : i + w * h * 3], dtype=np.uint8)
    return (img.reshape(h, w, 3).astype(np.float32)) / float(maxval)


def load_image(path: str) -> np.ndarray:
    if path.lower().endswith(".ppm"):
        return load_ppm(path)
    from PIL import Image

    img = Image.open(path).convert("RGB")
    return np.asarray(img, dtype=np.float32) / 255.0
