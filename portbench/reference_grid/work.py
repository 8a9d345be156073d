"""Work counts of the reference's own paths, for the benchmark's roofline
(portbench/roofline/grid.py): with `enabled` set, the engine adds up, over
the lanes that are alive, the closest-hit rays it traces, those whose
closest hit is a mesh triangle (mesh_closest), the shading vertices it
evaluates, the shadow rays their direct lighting needs (the adaptive soft
shadows' escalated samples only where they escalate) and those a mesh
blocks where no analytic primitive does (mesh_blocked). Nothing is counted
while `enabled` is False. portbench/reference/work.py's counts, and two
more."""

enabled = False
alive = None  # the alive lanes of the vertex being shaded
counts = {"lanes": 0, "closest_rays": 0, "mesh_closest": 0, "vertices": 0,
          "shadow_rays": 0, "mesh_blocked": 0}


def reset():
    for k in counts:
        counts[k] = 0


def add(name: str, n):
    counts[name] += int(n)
