"""allgather_wait_ms_per_image: host milliseconds rank 0 was blocked in
the mesh's all_gathers (parallel/mesh.stats["all_gather_s"]) per image of
the window."""

LAYER, SOURCE, MOVES = "parallel", "program_span", "samples_per_s"


def read(rec, ctx):
    return 1e3 * rec["counters"]["all_gather_s"] / len(rec["items"])
