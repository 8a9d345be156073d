"""Work counts of the reference's own paths, for the benchmark's roofline
(portbench/roofline): with `enabled` set, the engine adds up, over the
lanes that are alive, the closest-hit rays it traces, the shading vertices
it evaluates and the shadow rays their direct lighting needs (the adaptive
soft shadows' escalated samples only where they escalate). Nothing is
counted while `enabled` is False."""

enabled = False
alive = None  # the alive lanes of the vertex being shaded
counts = {"lanes": 0, "closest_rays": 0, "vertices": 0, "shadow_rays": 0}


def reset():
    for k in counts:
        counts[k] = 0


def add(name: str, n):
    counts[name] += int(n)
