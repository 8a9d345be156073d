"""qaray_tpu_torch: the PyTorch/CUDA port of qaray_tpu for NVIDIA Hopper.

A second package beside the JAX one, with its layout (core/ scene/ ops/
integrators/ photon/ fb/ parallel/ utils/ viz/ diff.py renderer.py
cli.py). It imports torch and never jax or qaray_tpu. The TPU's Pallas
kernels become CUDA C++ kernels (csrc/), built
with nvcc for sm_90a on first use; each sits beside a plain PyTorch version
that runs for tensors on the CPU. Entry points render on the GPU unless the
caller passes device="cpu".
"""

__version__ = "0.1.0"

from qaray_tpu_torch.scene.xml_parser import load_scene  # noqa: E402
from qaray_tpu_torch.scene.compiler import compile_scene  # noqa: E402
from qaray_tpu_torch.renderer import Renderer, RendererParam  # noqa: E402

__all__ = [
    "load_scene",
    "compile_scene",
    "Renderer",
    "RendererParam",
    "__version__",
]
