"""bvh_rays_per_sample: rays handed to the BVH walks in the window (the
program's ops/bvh_packed.stats, closest_rays + any_rays, which replays of
captured calls add to) over the window's camera samples; none where the
program has no such counters."""

LAYER, SOURCE, MOVES = "mesh", "program_counter", "samples_per_s"


def read(rec, ctx):
    c = rec["counters"]
    if "bvh.closest_rays" not in c:
        return None
    samples = sum(x["samples"] for x in rec["items"])
    return (c["bvh.closest_rays"] + c["bvh.any_rays"]) / samples
