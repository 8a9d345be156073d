"""Photon-cloud viewer: the counterpart of qaray_tpu/viz/photon_viz.py,
the reference's PhotonMapViz GLUT executable (src/exe/PhotonMapViz.cpp)
as PNGs: it reads a photon dump and writes three orthographic scatter
projections side by side.

    python -m qaray_tpu_torch.viz.photon_viz photonmap.dat out.png [--power]

The dump is what photon/build.save_photon_map writes (and the JAX
package's save_photon_map, byte for byte): 26-byte records "<fff f BBBB hh
xx" (position, power, rgb, plane, direction). The JAX viewer strides 28
bytes and misreads them; this one reads the records as written.
"""

from __future__ import annotations

import sys

import numpy as np

RECORD = np.dtype([("pos", "<f4", 3), ("power", "<f4"), ("rgb", "u1", 3),
                   ("plane", "u1"), ("theta", "<i2", 2), ("pad", "V2")])
assert RECORD.itemsize == 26


def read_photon_dump(path: str):
    """(pos [N, 3] float32, power [N] float32, color [N, 3] float32 in
    0..1) of every record in the dump."""
    rec = np.fromfile(path, dtype=RECORD)
    return (rec["pos"].astype(np.float32), rec["power"].astype(np.float32),
            rec["rgb"].astype(np.float32) / 255.0)


def render_scatter(pos, color, out_path: str, size: int = 800):
    """Three axis-aligned orthographic projections, side by side."""
    img = np.zeros((size, 3 * size, 3), np.float32)
    lo = pos.min(axis=0)
    hi = pos.max(axis=0)
    span = np.maximum(hi - lo, 1e-6)
    views = [(0, 1), (0, 2), (1, 2)]
    for v, (ax, ay) in enumerate(views):
        px = ((pos[:, ax] - lo[ax]) / span[ax] * (size - 1)).astype(int)
        py = ((pos[:, ay] - lo[ay]) / span[ay] * (size - 1)).astype(int)
        np.maximum.at(img, (size - 1 - py, v * size + px), color)
    from qaray_tpu_torch.fb.png import write_png

    write_png(out_path, (np.clip(img, 0, 1) * 255).astype(np.uint8))


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print(__doc__)
        return 1
    pos, power, color = read_photon_dump(argv[0])
    if "--power" in argv:
        color = np.clip(power[:, None] * np.ones((1, 3)), 0, 1)
    print(f"{pos.shape[0]} photons, bbox {pos.min(0)} .. {pos.max(0)}")
    render_scatter(pos, color, argv[1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
