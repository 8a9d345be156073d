"""Device-resident framebuffer accumulation.

Counterpart of qaray_tpu/fb/device_accum.py. The per-pixel Welford planes
live on the render device; each round's radiance updates them there, and
only the convergence mask and the final planes cross to the host. Where
JAX returned new arrays, these functions update the planes in place (one
copy of the image state instead of two).

The recurrence is the reference's (SuperSamplerHalton::Accumulate,
scene/scene.cpp:113-123):
    dc   = (x - mean) / (s + 1)
    mean += dc
    std  += s > 0 ? dc^2 * (s+1) - std / s : 0
"""

import numpy as np
import torch


def init_state(fb, device):
    """Host FrameBuffer -> device accumulator state."""
    return {
        "mean": torch.as_tensor(fb.mean, device=device).clone(),
        "std": torch.as_tensor(fb.color_std, device=device).clone(),
        "count": torch.as_tensor(fb.count, device=device).clone(),
    }


def _welford(mean, std, count, colors):
    s = count.to(torch.float32)[:, None]
    dc = (colors - mean) / (s + 1.0)
    upd = dc * dc * (s + 1.0) - std / torch.clamp_min(s, 1.0)
    return mean + dc, std + torch.where(s > 0, upd, 0.0), count + 1


def accumulate_round(state, pixel_ids, colors):
    """One new sample for each pixel id (ids unique within a call)."""
    ids = pixel_ids.long()
    mean, std, count = _welford(state["mean"][ids], state["std"][ids],
                                state["count"][ids], colors)
    state["mean"][ids] = mean
    state["std"][ids] = std
    state["count"][ids] = count
    return state


def accumulate_contig(state, start: int, colors):
    """accumulate_round for the contiguous pixel ids [start, start + B):
    slices instead of a gather and a scatter."""
    sl = slice(start, start + colors.shape[0])
    mean, std, count = _welford(state["mean"][sl], state["std"][sl],
                                state["count"][sl], colors)
    state["mean"][sl] = mean
    state["std"][sl] = std
    state["count"][sl] = count
    return state


def unconverged_ids(state, threshold, spp) -> np.ndarray:
    """Pixels still over the adaptive threshold at exactly `spp` samples
    (the host-side compaction input; one bool plane crosses to the host)."""
    th = torch.as_tensor(threshold, dtype=torch.float32,
                         device=state["std"].device)
    over = (state["std"] > th[None, :]).any(dim=-1)
    mask = (over & (state["count"] == spp)).cpu().numpy()
    return np.nonzero(mask)[0].astype(np.int32)


def sync_to_fb(state, fb):
    """Pull the device planes into the host FrameBuffer mirror."""
    fb.mean = state["mean"].cpu().numpy()
    fb.color_std = state["std"].cpu().numpy()
    fb.count = state["count"].cpu().numpy()
    return fb
