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
    -devices N                       shard each dispatch over N devices
    -multihost                       one process a rank (torch.distributed;
                                     from MASTER_ADDR, MASTER_PORT, RANK,
                                     WORLD_SIZE unless -coordinator), the
                                     render sharded over every rank's device
    -coordinator A,N,P               the group's address, process count and
                                     this process's rank
    -rank-debug                      with -multihost, each rank writes
                                     PREFIXrank{r}_maskBuffer.png and
                                     PREFIXrank{r}_sampleBuffer.png
    -profile DIR                     torch.profiler trace of the set-up and
                                     the render into DIR
    -serve PORT                      the preview server (viz/serve.py) on
                                     localhost:PORT; blocks
    -threads N                       the CPU's threads for torch

-batch is accepted for compatibility. Scenes may carry checker and file
textures on materials, the background and the environment. In a
-multihost run only rank 0 writes images.
"""

from __future__ import annotations

import sys

import torch

from qaray_tpu_torch.integrators.engine import INTEGRATORS
from qaray_tpu_torch.renderer import Renderer, RendererParam
from qaray_tpu_torch.scene.xml_parser import load_scene


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
            # The reference's TBB thread count; here the CPU's threads for
            # torch (the card's work does not depend on it).
            i += 1
            torch.set_num_threads(int(argv[i]))
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
        elif a == "-devices":
            i += 1
            param.num_devices = int(argv[i])
        elif a == "-multihost":
            # One process a rank, as the reference mpirun's its binary
            # (Renderer_MPI.cpp:35-53): the same CLI launched once a rank.
            opts["multihost"] = True
        elif a == "-rank-debug":
            param.rank_debug = True
        elif a == "-coordinator":
            i += 1
            addr, nproc, pid = argv[i].rsplit(",", 2)
            opts["coordinator"] = (addr, int(nproc), int(pid))
        elif a == "-profile":
            i += 1
            opts["profile"] = argv[i]
        elif a == "-serve":
            i += 1
            opts["serve"] = int(argv[i])
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
    device = opts["device"]
    if opts.get("multihost"):
        from qaray_tpu_torch.parallel import distributed
        from qaray_tpu_torch.parallel.mesh import default_devices

        rank, nprocs = distributed.init_distributed(
            *opts.get("coordinator", ()), device=device)
        device = distributed.local_device()
        param.num_devices = len(default_devices(device.type))
        print(f"multihost: process {rank}/{nprocs}, "
              f"{param.num_devices} devices", flush=True)
        name = (f" ({torch.cuda.get_device_name(device)})"
                if device.type == "cuda" else "")
        print(f"multihost: process {rank} on {device}{name}, collectives "
              f"on {distributed.backend()}", flush=True)
        try:
            return _run(param, scene_file, out_prefix, opts, device)
        finally:
            from qaray_tpu_torch.parallel.mesh import stats

            print(f"multihost: process {rank}, {stats['all_gathers']} "
                  f"all_gathers ({distributed.backend()}), "
                  f"{stats['all_gather_s']:f} s blocked in them", flush=True)
            distributed.shutdown()
    return _run(param, scene_file, out_prefix, opts, device)


def _run(param, scene_file, out_prefix, opts, device):
    try:
        scene = load_scene(scene_file)
    except (OSError, ValueError) as e:
        print(f'Failed to load the file "{scene_file}": {e}', file=sys.stderr)
        return -1
    if "res" in opts:
        scene.camera.img_width, scene.camera.img_height = opts["res"]
    renderer = Renderer(param, device=device)

    if "serve" in opts:
        from qaray_tpu_torch.viz.serve import RenderServer

        RenderServer(renderer, scene, opts["serve"]).serve(block=True)
        return 0

    from qaray_tpu_torch.utils.timing import FrameTimer, profile

    # The trace holds the set-up's spans (scene.compile, photon.build, the
    # captures) before the render's.
    with profile(opts.get("profile"), renderer.device):
        renderer.compute_scene(scene)
        renderer.set_progress_callback(
            lambda done, total: print(f"progress: {done}/{total} spp",
                                      flush=True))
        param.progressive_prefix = out_prefix

        timer = FrameTimer()
        timer.start()
        fb = renderer.render()
        timer.stop()

    if opts.get("multihost"):
        from qaray_tpu_torch.parallel.distributed import (
            is_primary,
            process_index,
        )

        # Each rank's debug planes before the primary-only gate
        # (Renderer_MPI.cpp:134-138 saves each rank's buffers before the
        # composite); then only the primary writes images (every rank holds
        # the whole gathered framebuffer).
        if param.rank_debug:
            renderer.save_rank_debug(out_prefix, process_index())
        if not is_primary():
            return 0

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
