"""The plain reference of the grid configuration: portbench/reference
with per-instance triangle meshes.

A scene of spheres, planes and placements of one OBJ mesh is worked out
again from the XML and the seed: the OBJ loader with the upstream's
computed normals (obj.py), the parser that shares one mesh by file name
(xml_parser.py), a per-instance compile (compiler.py), a plain tree over
the mesh and its walk (bvh.py), closest and any hits over the instances
in object space (trace.py), and copies of the reference's engine and
shading (engine.py, common.py) that trace through them and count the
mesh's work (work.py). Everything else is the reference's, imported from
it unchanged, its precision switch (reference/precision.py) included. It
imports nothing of the program.
"""
