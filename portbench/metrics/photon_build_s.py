"""photon_build_s: seconds of the photon maps' build in set-up
(photon/build.build_photon_maps, timed to a synchronise)."""

LAYER, SOURCE, MOVES = "photon", "program_span", "setup_s"


def read(rec, ctx):
    return rec["setup_parts"].get("photon_build_s")
