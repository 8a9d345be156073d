"""Device-resident framebuffer accumulation.

Counterpart of qaray_tpu/fb/device_accum.py. The per-pixel Welford planes
live on the render device; each round's radiance updates them there, and
only the convergence mask, the count of skipped lanes and the final planes
cross to the host. The folds read nothing on the host: the count of
skipped lanes comes back as a device tensor, which the Renderer reads when
it retires the dispatch. Where JAX returned new arrays, these functions
update the planes in place (one copy of the image state instead of two).
With photon maps a fourth plane max-folds the irradiance debug flags.

As in the JAX package the planes hold one row more than the image: row
N = W * H is the dump row, which the padding lanes of a dispatch (the
Renderer pads each to a power-of-two bucket) fold into; the image and the
convergence mask leave it out. The folds and the convergence mask run
under capture on the card (utils/compiled.py, the counterpart of the JAX
package's jax.jit over them), keyed on the planes' storage: init_state
copies a new render's planes into the previous state where the shapes
agree, so that a second render replays the first one's graphs.

The recurrence is the reference's (SuperSamplerHalton::Accumulate,
scene/scene.cpp:113-123):
    dc   = (x - mean) / (s + 1)
    mean += dc
    std  += s > 0 ? dc^2 * (s+1) - std / s : 0
"""

import numpy as np
import torch

from qaray_tpu_torch.utils.compiled import jit


def init_state(fb, device, want_irr: bool = False, into=None):
    """Host FrameBuffer -> device accumulator state, the dump row
    included (with want_irr the irradiance plane too, as 0..1 floats).
    into: a previous state, whose planes take the values in place where
    their shapes and kinds agree."""
    host = {"mean": np.pad(fb.mean, ((0, 1), (0, 0))),
            "std": np.pad(fb.color_std, ((0, 1), (0, 0))),
            "count": np.pad(fb.count, (0, 1))}
    if want_irr:
        host["irr"] = np.pad(fb.irrad.astype(np.float32) / 255.0, (0, 1))
    dev = torch.device(device)
    if (into is not None and into.keys() == host.keys()
            and all(into[k].device.type == dev.type
                    and dev.index in (None, into[k].device.index)
                    and tuple(into[k].shape) == v.shape
                    and into[k].dtype == torch.from_numpy(v).dtype
                    for k, v in host.items())):
        for k, v in host.items():
            into[k].copy_(torch.from_numpy(v))
        return into
    return {k: torch.as_tensor(v, device=device).clone()
            for k, v in host.items()}


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


def _accumulate_round(state, pixel_ids, colors, skip=None, irr=None):
    """One new sample for each pixel id (ids unique within a call but for
    the dump row N, the padding lanes' id).

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


accumulate_round = jit(_accumulate_round, state=("state",),
                       inputs=("pixel_ids", "colors", "skip", "irr"))


def _accumulate_contig(state, start: int, colors, skip=None, irr=None):
    """accumulate_round for the contiguous pixel ids [start, start + B):
    slices instead of a gather and a scatter. Here, as in the JAX package,
    the irradiance plane takes every lane's flag."""
    sl = slice(start, start + colors.shape[0])
    n_skip = _fold(state, sl, colors, skip)
    if "irr" in state and irr is not None:
        state["irr"][sl] = torch.maximum(state["irr"][sl],
                                         irr.to(torch.float32))
    return n_skip


# start is a host int, baked into the graph: part of its key.
accumulate_contig = jit(_accumulate_contig, state=("state",),
                        inputs=("colors", "skip", "irr"))


def _unconverged_mask(state, threshold, spp: int):
    std = state["std"][:-1]
    return (((std[:, 0] > threshold[0]) | (std[:, 1] > threshold[1])
             | (std[:, 2] > threshold[2]))
            & (state["count"][:-1] == spp))


# The device part of unconverged_ids (the JAX package's jitted
# _unconverged); threshold and spp are baked in.
_unconverged = jit(_unconverged_mask, state=("state",))


def unconverged_ids(state, threshold, spp, on_device: bool = False):
    """Pixels still over the adaptive threshold at exactly `spp` samples
    (the host-side compaction input; one bool plane crosses to the host,
    the round's one synchronizing read, as in the JAX Renderer). With
    on_device, (host ids, the same ids on the device, copied there from
    pinned memory without a wait)."""
    mask = _unconverged(state, tuple(float(x) for x in threshold),
                        int(spp)).cpu().numpy()
    ids = np.nonzero(mask)[0].astype(np.int32)
    if not on_device:
        return ids
    host = torch.from_numpy(ids)
    dev = state["std"].device
    if dev.type == "cuda":
        host = host.pin_memory()
    return ids, host.to(dev, non_blocking=True)


def sync_to_fb(state, fb):
    """Pull the device planes, without the dump row, into the host
    FrameBuffer mirror."""
    fb.mean = state["mean"][:-1].cpu().numpy()
    fb.color_std = state["std"][:-1].cpu().numpy()
    fb.count = state["count"][:-1].cpu().numpy()
    if "irr" in state:
        fb.irrad = (state["irr"][:-1].cpu().numpy() * 255.0).astype(np.uint8)
    return fb
