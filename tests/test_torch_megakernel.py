"""The port's megakernel entry point against qaray_tpu's Pallas megakernel.

On the CPU, ops.megakernel.mega_render runs the plain version of kernel
K1a (the wavefront engine); here it is held to qaray_tpu's mega_render in
interpret mode under a threefry key, with the bars of
tests/test_megakernel.py::_compare. tests/test_torch_gpu.py holds K1a itself
to the plain version on a card with the same bars.
"""

import jax
import numpy as np
import torch

from qaray_tpu.integrators.engine import IntegratorConfig as JaxConfig
from qaray_tpu.ops.pallas_pathtrace import mega_render as jax_mega_render
from qaray_tpu_torch.integrators.engine import IntegratorConfig
from qaray_tpu_torch.ops import megakernel
from test_torch_engine import compare, lanes, scenes

KW = dict(integrator="pathtrace", max_bounce=3, shadow_spp=4,
          shadow_spp_max=8)


def test_mega_render_matches_pallas_interpret():
    arrays, meta, tarr, tmeta = scenes("softdof")
    px, py, sid = lanes()
    key = jax.random.key(3, impl="threefry2x32")
    kd = jax.random.key_data(key)
    rad_j, t0_j = jax_mega_render(arrays, meta, JaxConfig(**KW),
                                  "threefry2x32", True, px, py, sid, kd)
    words = tuple(int(w) for w in np.asarray(kd))
    rad, t0 = megakernel.mega_render(tarr, tmeta, IntegratorConfig(**KW),
                                     torch.tensor(px), torch.tensor(py),
                                     torch.tensor(sid), words)
    compare(np.asarray(rad_j), np.asarray(t0_j), rad.numpy(), t0.numpy())
