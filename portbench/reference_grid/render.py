"""The grid reference's entry points: a scene from its XML and whole
images by the adaptive loop (portbench/reference/render.py's, over this
package's compile and engine)."""

from __future__ import annotations

import torch

from ..reference import precision as PR
from ..reference.render import _cast, _welford
from ..reference.rng import key_words
from .compiler import compile_scene
from .engine import IntegratorConfig, render_lanes
from .xml_parser import load_scene

__all__ = ["IntegratorConfig", "key_words", "load", "render_image"]


def load(xml_path: str, width: int, height: int, device):
    """(SceneArrays, SceneMeta) of the XML at width x height, its float
    tables in the reference's precision (reference/precision.py)."""
    desc = load_scene(xml_path)
    desc.camera.img_width, desc.camera.img_height = width, height
    arrays, meta = compile_scene(desc, device=device)
    return _cast(arrays, PR.dtype()), meta


def render_image(arrays, meta, cfg: IntegratorConfig, words, spp_min: int,
                 spp_max: int, threshold, block: int = 1 << 20, rows=None):
    """One image by the Renderer's loop: spp_min samples of every pixel,
    then rounds of one sample of each pixel whose std is over `threshold`
    in any channel at exactly that count, up to spp_max. Sample s of pixel
    i is keyed on (words, i, s). rows: the image rows to render (all by
    default). Returns (mean [N, 3], count [N]) over the rows' N pixels, in
    row-major order."""
    w, h = meta.img_width, meta.img_height
    dev = arrays.camera.pos.device
    rows = torch.arange(h, device=dev) if rows is None else rows.to(dev)
    pix = (rows[:, None] * w + torch.arange(w, device=dev)[None, :]
           ).reshape(-1).to(torch.int64)
    n = pix.shape[0]
    mean = torch.zeros((n, 3), dtype=PR.dtype(), device=dev)
    std = torch.zeros((n, 3), dtype=PR.dtype(), device=dev)
    count = torch.zeros(n, dtype=torch.int32, device=dev)
    th = torch.tensor(threshold, dtype=PR.dtype(), device=dev)

    def rounds_of(sel, s0, k):
        """Samples s0..s0+k-1 of the pixels `sel`, rendered together (a
        lane's radiance does not depend on its batch) and folded one
        sample after the other."""
        for a in range(0, sel.shape[0], max(1, block // k)):
            rows_i = sel[a:a + max(1, block // k)]
            ids = pix[rows_i].repeat(k)
            sid = (torch.arange(s0, s0 + k, dtype=torch.int32, device=dev)
                   .repeat_interleave(rows_i.shape[0]))
            rad, _ = render_lanes(arrays, meta, cfg, (ids % w).to(torch.int32),
                                  (ids // w).to(torch.int32), sid, words)
            for j in range(k):
                part = rad[j * rows_i.shape[0]:(j + 1) * rows_i.shape[0]]
                m, sd, c = _welford(mean[rows_i], std[rows_i], count[rows_i],
                                    part.to(mean.dtype))
                mean[rows_i], std[rows_i], count[rows_i] = m, sd, c

    everyone = torch.arange(n, device=dev)
    with torch.no_grad():
        per_call = max(1, min(spp_min, block // max(n, 1)))
        for s in range(0, spp_min, per_call):
            rounds_of(everyone, s, min(per_call, spp_min - s))
        for s in range(spp_min, spp_max):
            active = torch.nonzero(((std > th[None, :]).any(dim=1))
                                   & (count == s))[:, 0]
            if active.numel() == 0:
                break
            rounds_of(active, s, 1)
    return mean, count
