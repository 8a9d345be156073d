"""Device-resident framebuffer accumulation.

Counterpart of qaray_tpu/fb/device_accum.py. The per-pixel Welford planes
live on the render device; each round's radiance updates them there, and
only the convergence mask, the count of skipped lanes and the final planes
cross to the host. The folds read nothing on the host: the count of
skipped lanes comes back as a device tensor, which the Renderer reads when
it retires the dispatch. Where JAX returned new arrays, these functions
update the planes in place (one copy of the image state instead of two).
With photon maps a fourth plane max-folds the irradiance debug flags.

The recurrence is the reference's (SuperSamplerHalton::Accumulate,
scene/scene.cpp:113-123):
    dc   = (x - mean) / (s + 1)
    mean += dc
    std  += s > 0 ? dc^2 * (s+1) - std / s : 0
"""

import numpy as np
import torch


def init_state(fb, device, want_irr: bool = False):
    """Host FrameBuffer -> device accumulator state (with want_irr the
    irradiance plane too, as 0..1 floats)."""
    state = {
        "mean": torch.as_tensor(fb.mean, device=device).clone(),
        "std": torch.as_tensor(fb.color_std, device=device).clone(),
        "count": torch.as_tensor(fb.count, device=device).clone(),
    }
    if want_irr:
        state["irr"] = torch.as_tensor(
            fb.irrad.astype(np.float32) / 255.0, device=device)
    return state


def _welford(mean, std, count, colors):
    s = count.to(torch.float32)[:, None]
    dc = (colors - mean) / (s + 1.0)
    upd = dc * dc * (s + 1.0) - std / torch.clamp_min(s, 1.0)
    return mean + dc, std + torch.where(s > 0, upd, 0.0), count + 1


def _fold(state, where, colors, skip):
    """Welford update of the rows `where` (an index tensor or a slice);
    rows of skipped lanes keep their values and count. Returns the number
    of skipped lanes as a 0-d int tensor on the device (None without
    skip)."""
    m, sd, c = state["mean"][where], state["std"][where], state["count"][where]
    mean, std, count = _welford(m, sd, c, colors)
    n_skip = None
    if skip is not None:
        keep = skip[:, None]
        mean = torch.where(keep, m, mean)
        std = torch.where(keep, sd, std)
        count = torch.where(skip, c, count)
        n_skip = skip.sum()
    state["mean"][where] = mean
    state["std"][where] = std
    state["count"][where] = count
    return n_skip


def accumulate_round(state, pixel_ids, colors, skip=None, irr=None):
    """One new sample for each pixel id (ids unique within a call).

    skip: optional bool [B], lanes NOT folded by this call (gather-escalated
    lanes, folded later with their exact radiance); irr: optional bool [B],
    max-folded into the irradiance plane (skipped lanes not, as in the JAX
    package). Returns the number of skipped lanes (_fold)."""
    ids = pixel_ids.long()
    n_skip = _fold(state, ids, colors, skip)
    if "irr" in state and irr is not None:
        flag = irr if skip is None else irr & ~skip
        state["irr"][ids] = torch.maximum(state["irr"][ids],
                                          flag.to(torch.float32))
    return n_skip


def accumulate_contig(state, start: int, colors, skip=None, irr=None):
    """accumulate_round for the contiguous pixel ids [start, start + B):
    slices instead of a gather and a scatter. Here, as in the JAX package,
    the irradiance plane takes every lane's flag."""
    sl = slice(start, start + colors.shape[0])
    n_skip = _fold(state, sl, colors, skip)
    if "irr" in state and irr is not None:
        state["irr"][sl] = torch.maximum(state["irr"][sl],
                                         irr.to(torch.float32))
    return n_skip


def unconverged_ids(state, threshold, spp, on_device: bool = False):
    """Pixels still over the adaptive threshold at exactly `spp` samples
    (the host-side compaction input; one bool plane crosses to the host,
    the round's one synchronizing read). With on_device, (host ids, the
    same ids on the device, copied there from pinned memory without a
    wait)."""
    std = state["std"]
    over = ((std[:, 0] > threshold[0]) | (std[:, 1] > threshold[1])
            | (std[:, 2] > threshold[2]))
    mask = (over & (state["count"] == spp)).cpu().numpy()
    ids = np.nonzero(mask)[0].astype(np.int32)
    if not on_device:
        return ids
    host = torch.from_numpy(ids)
    if std.device.type == "cuda":
        host = host.pin_memory()
    return ids, host.to(std.device, non_blocking=True)


def sync_to_fb(state, fb):
    """Pull the device planes into the host FrameBuffer mirror."""
    fb.mean = state["mean"].cpu().numpy()
    fb.color_std = state["std"].cpu().numpy()
    fb.count = state["count"].cpu().numpy()
    if "irr" in state:
        fb.irrad = (state["irr"].cpu().numpy() * 255.0).astype(np.uint8)
    return fb
