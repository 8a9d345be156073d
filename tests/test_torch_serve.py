"""The port's preview server (qaray_tpu_torch/viz/serve.py): the
counterpart of tests/test_serve.py on spot_scene at 64x48 on the CPU, with
every endpoint it checks, and restart and set."""

import json
import time
import urllib.error
import urllib.request

import pytest

from qaray_tpu_torch.renderer import Renderer, RendererParam
from qaray_tpu_torch.scene.xml_parser import load_scene
from qaray_tpu_torch.viz.serve import RenderServer


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.status, r.read()


def _wait(srv, gen0, spp=2):
    """/status once the render after generation gen0 has finished."""
    deadline = time.time() + 120
    while time.time() < deadline:
        st = json.loads(_get(srv.port, "/status")[1])
        if st["generation"] > gen0 and not st["rendering"] \
                and st["spp"] >= spp:
            return st
        time.sleep(0.1)
    pytest.fail(f"no finished render after generation {gen0}: {st}")


def test_serve_lifecycle():
    scene = load_scene("tests/assets/spot_scene.xml")
    scene.camera.img_width, scene.camera.img_height = 64, 48
    r = Renderer(RendererParam(spp_min=2, spp_max=2, max_bounce=2,
                               shadow_spp=4, shadow_spp_max=8),
                 device="cpu")
    srv = RenderServer(r, scene, port=0).serve(block=False)
    try:
        st = _wait(srv, 0)
        assert st["spp_max"] == 2 and st["integrator"] == "photonmap"

        code, first = _get(srv.port, "/image.png")
        assert code == 200 and first[:4] == b"\x89PNG"
        code, page = _get(srv.port, "/")
        assert code == 200 and b"preview" in page
        for path in ("/depth.png", "/spp.png", "/irradiance.png"):
            code, body = _get(srv.port, path)
            assert code == 200 and body[:4] == b"\x89PNG", path
        code, probe = _get(srv.port, "/probe?x=32&y=24")
        assert b"Color3c" in probe and b"Z:" in probe
        _, probe = _get(srv.port, "/probe?x=640&y=0")
        assert b"Invalid pixel" in probe
        with pytest.raises(urllib.error.HTTPError):
            _get(srv.port, "/nothing")

        # orbit: the camera moves, the scene is recompiled, a new image.
        _get(srv.port, "/orbit?dyaw=30")
        st = _wait(srv, st["generation"])
        _, orbited = _get(srv.port, "/image.png")
        assert orbited != first, "orbit did not change the image"

        # restart: the same state renders the same image again.
        code, body = _get(srv.port, "/restart")
        assert code == 200 and body == b"restarted"
        st = _wait(srv, st["generation"])
        assert _get(srv.port, "/image.png")[1] == orbited

        # set: new parameters, restarted.
        code, body = _get(srv.port, "/set?spp=3&bounce=1&integrator=basic")
        assert code == 200 and body == b"ok"
        st = _wait(srv, st["generation"], spp=3)
        assert st["spp_max"] == 3 and st["integrator"] == "basic"
        assert r.param.max_bounce == 1 and r.param.spp_min == 3
        assert _get(srv.port, "/image.png")[1] != orbited
    finally:
        srv.shutdown()
    assert srv._worker is None
