"""Writes the grid configuration's scene: rock6.obj, a lumpy rock of
81,920 triangles, and grid_scene.xml, 144 placements of it on a 12 x 12
field over a ground plane.

    python3 portbench/scenes/make_grid.py [--out DIR]

Deterministic, numpy only: a rerun rewrites both files byte for byte
(DIR defaults to this file's directory).

The rock: the unit icosphere subdivided 6 times (40,962 vertices, 81,920
faces; each face split into four at its edges' normalised midpoints),
each vertex moved radially, in float64, by

    r(p) = 1 + 0.12 sin(3.1x + 0.4) sin(2.7y + 1.3) sin(3.7z + 2.1)
             + 0.04 sin(11x + 0.7) sin(13y + 0.2) sin(9z + 1.1)

and written as `v` lines with 6 decimals and `f` lines; no normals, so the
loader computes them as the upstream's TriMesh::ComputeNormals does.

The field: rock k (row-major over y, then x, both in -11, -9, ..., 11, at
z = 0) is scaled by 0.75 + 0.01 (k mod 11), rotated about z by (37 k) mod
360 degrees and takes material `m` (k even) or `grey` (k odd).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

SUBDIV = 6
GRID = 12
OBJ_NAME = "rock6.obj"
XML_NAME = "grid_scene.xml"


def icosphere(subdiv: int):
    """Unit icosphere in float64: (vertices [V, 3], faces [F, 3])."""
    t = (1.0 + 5**0.5) / 2.0
    verts = [
        (-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
        (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
        (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1),
    ]
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    verts = [np.array(v, float) / np.linalg.norm(v) for v in verts]
    cache = {}

    def midpoint(i, j):
        key = (min(i, j), max(i, j))
        if key not in cache:
            m = verts[i] + verts[j]
            verts.append(m / np.linalg.norm(m))
            cache[key] = len(verts) - 1
        return cache[key]

    for _ in range(subdiv):
        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (ab, b, bc), (ca, bc, c),
                          (ab, bc, ca)]
        faces = new_faces
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def radius(p):
    """r(p) of the unit-sphere points p [V, 3], float64."""
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    return (1.0
            + 0.12 * np.sin(3.1 * x + 0.4) * np.sin(2.7 * y + 1.3)
            * np.sin(3.7 * z + 2.1)
            + 0.04 * np.sin(11.0 * x + 0.7) * np.sin(13.0 * y + 0.2)
            * np.sin(9.0 * z + 1.1))


def rock(subdiv: int = SUBDIV):
    """The rock: (vertices [V, 3] float64, faces [F, 3])."""
    v, f = icosphere(subdiv)
    return v * radius(v)[:, None], f


def obj_text(v, f) -> str:
    lines = [f"# {OBJ_NAME}: the unit icosphere subdivided {SUBDIV} times, "
             "displaced radially (portbench/scenes/make_grid.py)"]
    lines += [f"v {a:.6f} {b:.6f} {c:.6f}" for a, b, c in v]
    lines += [f"f {a + 1} {b + 1} {c + 1}" for a, b, c in f]
    return "\n".join(lines) + "\n"


def placements():
    """(x, y, scale, angle in degrees, material) of each rock, row-major."""
    out = []
    coords = [-11 + 2 * i for i in range(GRID)]
    for k in range(GRID * GRID):
        y, x = coords[k // GRID], coords[k % GRID]
        out.append((x, y, 0.75 + 0.01 * (k % 11), (37 * k) % 360,
                    "m" if k % 2 == 0 else "grey"))
    return out


def scene_xml(obj_name: str = OBJ_NAME, rocks=None) -> str:
    """The scene: `rocks` (placements() by default) of obj_name over the
    ground, the materials, the lights and the camera."""
    lines = ["<xml><scene>",
             '<object type="plane" name="ground" material="ground">'
             '<scale value="40"/><translate x="0" y="0" z="-0.9"/>'
             "</object>"]
    for x, y, s, a, mtl in placements() if rocks is None else rocks:
        lines.append(
            f'<object type="obj" name="{obj_name}" material="{mtl}">'
            f'<scale value="{s:.2f}"/><rotate angle="{a}" z="1"/>'
            f'<translate x="{x}" y="{y}" z="0"/></object>')
    lines += [
        '<material type="blinn" name="m"><diffuse r="0.7" g="0.3" b="0.2"/>'
        '<specular value="0.5"/><glossiness value="20"/></material>',
        '<material type="blinn" name="grey"><diffuse value="0.45"/>'
        '<specular value="0.3"/><glossiness value="60"/>'
        '<reflection value="0.2"/></material>',
        '<material type="blinn" name="ground"><diffuse value="0.5"/>'
        '<specular value="0"/></material>',
        '<light type="point" name="l"><intensity value="700"/>'
        '<position x="10" y="-16" z="20"/></light>',
        '<light type="ambient" name="a"><intensity value="0.1"/></light>',
        "</scene>",
        '<camera><position x="0" y="-28" z="9"/><target x="0" y="2" z="0"/>'
        '<up x="0" y="0" z="1"/><fov value="45"/><width value="640"/>'
        '<height value="480"/></camera></xml>']
    return "\n".join(lines) + "\n"


def write(out: Path):
    v, f = rock()
    (out / OBJ_NAME).write_text(obj_text(v, f))
    (out / XML_NAME).write_text(scene_xml())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(Path(__file__).resolve().parent))
    write(Path(ap.parse_args(argv).out))


if __name__ == "__main__":
    main()
