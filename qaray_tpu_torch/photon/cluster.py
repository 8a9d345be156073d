"""Photon-map clustering for the cluster-culled gather (kernels K5 and K1d).

Counterpart of qaray_tpu/photon/cluster.py. Photons are Morton-ordered by
position and packed 128 to a cluster; each cluster keeps an axis-aligned
box, which lets a gather skip every cluster farther than the radius from
its queries (ops/photon.py, csrc/photon.cuh).

Table layout ([Fp, 16] float32 rows, one photon a row):
  cols 0-2   position
  cols 3-5   RGB power (already scaled by 1 / emitted paths)
  cols 6-8   max_power * direction (the filter-weighted direction sum of
             EstimateIrradiance adds w * maxPower * dir)
  cols 9-15  zero
Padding rows sit at position 1e30: their d^2 overflows to +inf, so they
never fall inside a radius and add exactly zero.
"""

import numpy as np
import torch

PHOTON_CLUSTER = 128  # photons a cull cluster

# EstimateIrradiance<100>: the reference's compile-time cap on the photons
# a gather uses (MtlBlinn_PhotonMap.cpp:426-458).
GATHER_K = 100


def pack_photon_clusters(pos, power, direction, max_power, valid,
                         cluster: int = PHOTON_CLUSTER):
    """Valid photons -> (ctable [Fp, 16], cbounds [C, 8]) numpy arrays.

    Rows in Morton order of position (tight cluster boxes). An empty map
    packs to one all-padding cluster with an inverted box, which no cull
    accepts."""
    from qaray_tpu_torch.ops.mesh_tiles import _morton3

    def host(a, dtype):
        if torch.is_tensor(a):
            a = a.detach().cpu().numpy()
        return np.asarray(a, dtype)

    valid = host(valid, bool)
    pos = host(pos, np.float32)[valid]
    power = host(power, np.float32)[valid]
    pdir = (host(direction, np.float32)[valid]
            * host(max_power, np.float32)[valid][:, None])
    n = pos.shape[0]
    if n:
        order = np.argsort(_morton3(pos), kind="stable")
        pos, power, pdir = pos[order], power[order], pdir[order]
    fp = max(((n + cluster - 1) // cluster) * cluster, cluster)
    tab = np.zeros((fp, 16), np.float32)
    tab[:, 0:3] = 1e30  # padding rows: infinitely far away
    tab[:n, 0:3] = pos
    tab[:n, 3:6] = power
    tab[:n, 6:9] = pdir
    nc = fp // cluster
    cb = np.zeros((nc, 8), np.float32)
    for c in range(nc):
        rows = pos[c * cluster:(c + 1) * cluster]
        if rows.size == 0:
            cb[c, 0:3] = 1.0
            cb[c, 3:6] = -1.0  # inverted: never overlaps
        else:
            cb[c, 0:3] = rows.min(axis=0)
            cb[c, 3:6] = rows.max(axis=0)
    return tab, cb


def cluster_photon_map(pmap, cluster: int = PHOTON_CLUSTER):
    """PhotonMapData -> PhotonMapData with ctable / cbounds on the map's
    device."""
    tab, cb = pack_photon_clusters(pmap.pos, pmap.power, pmap.direction,
                                   pmap.max_power, pmap.valid, cluster)
    dev = pmap.pos.device
    return pmap._replace(ctable=torch.as_tensor(tab, device=dev),
                         cbounds=torch.as_tensor(cb, device=dev))
