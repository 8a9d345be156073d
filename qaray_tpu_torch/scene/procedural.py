"""Procedural meshes and textures for tests and the GPU smoke run.

icosphere(subdiv) is the subdivided icosahedron of the mesh-scale
measurements (20 * 4**subdiv triangles: ico5 = 20,480, ico6 = 81,920);
with_mesh puts such a mesh in place of the first OBJ node of a parsed
scene, keeping its transform and material, and with_shared_mesh in place
of every OBJ node's, one mesh instanced by them all; with_texture binds a
checker or an image to a material slot, the background or the
environment; with_glass gives one object a glass material of its own;
scatter_instances makes a table of many transformed instances of one.
"""

from __future__ import annotations

import copy
import sys

import numpy as np


def icosphere(subdiv: int = 2):
    """Unit icosphere: (vertices [V, 3] float32, faces [F, 3] int32)."""
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
            new_faces += [(a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca)]
        faces = new_faces
    return (np.asarray(verts, np.float32), np.asarray(faces, np.int32))


def with_mesh(scene, verts, faces, name: str = "procedural"):
    """A copy of `scene` whose first OBJ node holds the mesh (verts, faces)."""
    scene = copy.deepcopy(scene)

    def find(node):
        if node.mesh is not None:
            return node
        for child in node.children:
            found = find(child)
            if found is not None:
                return found
        return None

    node = find(scene.root)
    if node is None:
        raise ValueError("the scene has no OBJ node to replace")
    # The node's own MeshDesc class, so that a scene parsed by another
    # package with the same fields gets a mesh of its own kind.
    node.mesh = type(node.mesh)(name=name,
                                vertices=np.asarray(verts, np.float32),
                                faces=np.asarray(faces, np.int32))
    return scene


def with_shared_mesh(scene, verts, faces, name: str = "procedural"):
    """A copy of `scene` whose every OBJ node holds one shared mesh (verts,
    faces): each node an instance of it with the node's own transform and
    material (one tree per unique mesh in a per-instance compile)."""
    scene = copy.deepcopy(scene)
    nodes, stack = [], [scene.root]
    while stack:
        node = stack.pop()
        if node.mesh is not None:
            nodes.append(node)
        stack.extend(node.children)
    if not nodes:
        raise ValueError("the scene has no OBJ node to replace")
    mesh = type(nodes[0].mesh)(name=name,
                               vertices=np.asarray(verts, np.float32),
                               faces=np.asarray(faces, np.int32))
    for node in nodes:
        node.mesh = mesh
    return scene


def with_texture(scene, where, *, checker=None, image=None, color=None,
                 scale=1.0, angle=0.0, offset=(0.0, 0.0, 0.0)):
    """A copy of `scene` with a texture bound at `where`: "background",
    "environment" or (material name, slot name).

    checker: (color1, color2) of a procedural checker; image: [H, W, 3]
    float array of a file texture (scene.textures.load_image). The map's
    transform scales by `scale`, rotates by `angle` degrees about w, then
    translates by `offset`, as the XML's <scale>, <rotate> and <translate>
    children of a textured colour do. color: the slot's flat colour, kept
    when None."""
    scene = copy.deepcopy(scene)
    desc = sys.modules[type(scene).__module__]  # the scene's own classes
    if checker is not None:
        tex = desc.TextureDesc(name="checkerboard", kind="checker")
        tex.color1 = np.asarray(checker[0], float)
        tex.color2 = np.asarray(checker[1], float)
    else:
        tex = desc.TextureDesc(name=f"image{len(scene.textures)}",
                               kind="file", image=np.asarray(image))
    scene.textures.append(tex)
    xform = desc.Affine()
    xform.scale(scale, scale, scale)
    if angle:
        xform.rotate(np.array([0.0, 0.0, 1.0]), angle)
    xform.translate(np.asarray(offset, float))
    holder, attr = ((scene, where) if isinstance(where, str)
                    else (scene.find_material(where[0]), where[1]))
    flat = getattr(holder, attr).color if color is None else color
    setattr(holder, attr, desc.TexturedColor(
        np.asarray(flat, float), desc.TextureMapDesc(texture=tex,
                                                     xform=xform)))
    return scene


def with_glass(scene, name: str, refraction=(0.9, 0.9, 0.9), ior=1.5,
               absorption=(0.01, 0.001, 0.01)):
    """A copy of `scene` whose object `name` gets a glass material of its
    own, "<name>_glass": its old material with diffuse 0, specular 0, the
    given refraction colour, index and Beer absorption. The other objects
    keep their materials. A glass object is what a caustics photon map
    needs: a first hit on a zero-diffuse surface."""
    scene = copy.deepcopy(scene)
    desc = sys.modules[type(scene).__module__]  # the scene's own classes

    def find(node):
        if node.name == name and node.obj_type is not None:
            return node
        for child in node.children:
            found = find(child)
            if found is not None:
                return found
        return None

    node = find(scene.root)
    if node is None:
        raise ValueError(f"the scene has no object named {name!r}")
    old = scene.find_material(node.mtl_name)
    mtl = (copy.deepcopy(old) if old is not None
           else desc.MaterialDesc(name=""))
    mtl.name = f"{name}_glass"
    mtl.diffuse = desc.TexturedColor(np.zeros(3))
    mtl.specular = desc.TexturedColor(np.zeros(3))
    mtl.refraction = desc.TexturedColor(np.asarray(refraction, float))
    mtl.ior = float(ior)
    mtl.absorption = np.asarray(absorption, float)
    scene.materials.append(mtl)
    node.mtl_name = mtl.name
    return scene


def scatter_instances(xf_row, n: int, seed: int, spread: float = 2.0,
                      scale: float = 0.3):
    """n instances of the instance whose W1 transform row is xf_row ([12]:
    M_w2o row-major, then t_o2w): instance k is the original turned by a
    random rotation, scaled by `scale` and moved by a random offset within
    `spread` times the original's scale (its object-to-world matrix's
    largest column) on every axis; instance 1 is mirrored. Returns a
    float32 [n, 12] numpy array of such rows (inverse matrices in
    float64, rounded once)."""
    rs = np.random.RandomState(seed)
    row = np.asarray(xf_row, np.float64)
    m_o2w = np.linalg.inv(row[:9].reshape(3, 3))
    reach = spread * float(np.linalg.norm(m_o2w, axis=0).max())
    rows = []
    for k in range(n):
        q, r = np.linalg.qr(rs.normal(size=(3, 3)))
        turn = q * np.sign(np.diag(r))
        if k == 1:
            turn[:, 0] *= -1.0
        m = m_o2w @ turn * scale
        rows.append(np.concatenate([np.linalg.inv(m).reshape(9),
                                    row[9:12] + rs.uniform(-reach, reach,
                                                           3)]))
    return np.stack(rows).astype(np.float32)
