"""The benchmark's plain reference of the renderer, in plain torch.

Frozen copies of the XML parser, the analytic scene compiler, the threefry
key streams, the wavefront engine's photonmap and pathtrace integrators,
the photon build with its exact gathers and the Welford fold, cut to
scenes of spheres and planes. It imports nothing of the program: it works
the scene, the photon maps, the images and the gradients out again from
the XML and the seed (render.py).
"""
