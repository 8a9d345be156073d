"""CLI entry point with the flags of qaray_tpu/cli.py (reference
src/main.cpp:8-61):

    python -m qaray_tpu_torch.cli scene.xml -res 800x600 -spp 8 -out PREFIX

    -spp N / -sppMin N / -sppMax N   samples per pixel
    -bounce N                        path depth
    -srgb 0|1                        sRGB output
    -integrator {photonmap,pathtrace,basic,whitted,phong,mcgi}
    -seed N                          RNG seed
    -shadow-spp N / -shadow-spp-max N   soft-shadow sample budget
    -use-photon-map                  photon-map gathers (photonmap); writes
                                     photonmap.dat and caustics.dat into
                                     the working directory and
                                     PREFIXirradianceBuffer.png
    -photon-map-size N / -caustics-map-size N   photons a map
    -progressive N                   save a preview PNG every N spp
    -probe X,Y                       print RGB+z at a pixel after the render
    -res WxH                         resolution override
    -out PREFIX                      output file prefix
    -device cpu                      render on the CPU (default: the GPU)

-batch and -threads are accepted for compatibility. Scenes may carry
checker and file textures on materials, the background and the environment.
Several devices, multihost runs, rank-debug planes, the preview server and
profiling come with later slices of the port and raise NotImplementedError.
"""

from __future__ import annotations

import sys
import time

from qaray_tpu_torch.integrators.engine import INTEGRATORS
from qaray_tpu_torch.renderer import Renderer, RendererParam
from qaray_tpu_torch.scene.xml_parser import load_scene

# Flags of later slices: what they bring, and the slice.
_LATER = {
    "-devices": ("multi-device rendering", "multi-device"),
    "-multihost": ("multihost rendering", "multi-device"),
    "-rank-debug": ("rank-debug planes", "multi-device"),
    "-coordinator": ("multihost rendering", "multi-device"),
    "-serve": ("the preview server", "preview-server"),
    "-profile": ("profiling", "timing and profiling"),
}


def parse_args(argv):
    param = RendererParam()
    scene_file = None
    out_prefix = ""
    opts = {"device": "cuda"}
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-batch",):
            pass
        elif a == "-spp":
            i += 1
            param.spp_max = param.spp_min = int(argv[i])
        elif a == "-sppMin":
            i += 1
            param.spp_min = int(argv[i])
        elif a == "-sppMax":
            i += 1
            param.spp_max = int(argv[i])
        elif a == "-bounce":
            i += 1
            param.max_bounce = int(argv[i])
        elif a == "-srgb":
            i += 1
            param.use_srgb = int(argv[i]) != 0
        elif a == "-threads":
            i += 1
        elif a == "-use-photon-map":
            param.use_photon_map = True
        elif a == "-photon-map-size":
            i += 1
            param.photon_map_size = int(argv[i])
        elif a == "-caustics-map-size":
            i += 1
            param.caustics_map_size = int(argv[i])
        elif a == "-integrator":
            i += 1
            if argv[i] not in INTEGRATORS:
                raise ValueError(f"-integrator {argv[i]}: one of "
                                 f"{', '.join(INTEGRATORS)}")
            param.integrator = argv[i]
        elif a == "-seed":
            i += 1
            param.seed = int(argv[i])
        elif a == "-out":
            i += 1
            out_prefix = argv[i]
        elif a == "-device":
            i += 1
            opts["device"] = argv[i]
        elif a == "-res":
            i += 1
            w, h = argv[i].lower().split("x")
            opts["res"] = (int(w), int(h))
        elif a == "-progressive":
            i += 1
            param.progressive_every = int(argv[i])
        elif a == "-shadow-spp":
            i += 1
            param.shadow_spp = int(argv[i])
        elif a == "-shadow-spp-max":
            i += 1
            param.shadow_spp_max = int(argv[i])
        elif a == "-probe":
            i += 1
            x, y = argv[i].split(",")
            opts.setdefault("probe", []).append((int(x), int(y)))
        elif a == "-platform":
            raise ValueError("-platform selects a JAX backend; the port "
                             "takes -device cpu")
        elif a in _LATER:
            what, slice_ = _LATER[a]
            raise NotImplementedError(
                f"{a}: {what} come with the {slice_} slice of the port")
        else:
            scene_file = a
        i += 1
    return param, scene_file, out_prefix, opts


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    param, scene_file, out_prefix, opts = parse_args(argv)
    if scene_file is None:
        print("Error: insufficient input", file=sys.stderr)
        return -1
    try:
        scene = load_scene(scene_file)
    except (OSError, ValueError) as e:
        print(f'Failed to load the file "{scene_file}": {e}', file=sys.stderr)
        return -1
    if "res" in opts:
        scene.camera.img_width, scene.camera.img_height = opts["res"]
    renderer = Renderer(param, device=opts["device"])
    renderer.compute_scene(scene)
    renderer.set_progress_callback(
        lambda done, total: print(f"progress: {done}/{total} spp",
                                  flush=True))
    param.progressive_prefix = out_prefix
    start = time.time()
    fb = renderer.render()
    print(f"render: {time.time() - start:.3f} s on {opts['device']}",
          flush=True)

    # Output names follow Renderer_GUI::CleanRender (Renderer_GUI.cpp:65-73).
    fb.save_image(out_prefix + "colorBuffer.png")
    fb.save_z_image(out_prefix + "depthBuffer.png")
    fb.save_sample_count_image(out_prefix + "sampleBuffer.png")
    if param.use_photon_map:
        fb.save_irradiance_image(out_prefix + "irradianceBuffer.png")
    for x, y in opts.get("probe", []):
        try:
            r, g, b, z = fb.probe(x, y)
            print(f"Pixel [ {x}, {y} ] Color3c: {r}, {g}, {b}   Z: {z:f}")
        except IndexError as e:
            print(str(e))
    return 0


if __name__ == "__main__":
    sys.exit(main())
