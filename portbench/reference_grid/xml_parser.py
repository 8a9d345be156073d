"""The reference's XML parser (portbench/reference/xml_parser.py) with OBJ
nodes: a node of type "obj" loads its file once (obj.load_obj) and every
node that names the same file shares that mesh, as the upstream's
xmlload.cpp:226-273 shares one TriObj by name. A missing file renders the
node empty with the upstream's error line."""

from __future__ import annotations

import sys
from typing import List, Optional

from ..reference import desc as D
from ..reference.xml_parser import SceneParser
from .obj import load_obj


class GridParser(SceneParser):
    def _load_obj_node(self, node: D.NodeDesc, mtl_name: Optional[str]):
        name = node.name
        mesh = self.meshes.get(name)
        if mesh is None:
            path = self._resolve_path(name)
            if path is None:
                print(f'ERROR: Cannot load file "{name}".', file=sys.stderr)
                return
            mesh = self.meshes[name] = load_obj(path)
        node.obj_type = "mesh"
        node.mesh = mesh


def load_scene(filename: str,
               search_paths: Optional[List[str]] = None) -> D.SceneDesc:
    return GridParser(search_paths).parse(filename)
