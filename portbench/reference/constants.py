"""Numeric constants shared across the framework.

These mirror the reference's constants so that images agree:
- BIGFLOAT: sentinel "no hit" distance      (core/setup.h:44 in the reference)
- BIAS: self-intersection epsilon           (objects/objects.cpp:19)
- DIFF_DX/DIFF_DY: differential-ray offsets (core/ray.cpp:31-34)
- PLANE_EPS: parallel-ray guard             (objects/objects.cpp:154)
- Adaptive supersampling thresholds         (renderers/renderer.cpp:305)
"""

BIGFLOAT = 1.0e30
BIAS = 0.005

# Differential-ray pixel offsets (reference core/ray.cpp:31-34).
DIFF_DX = 0.01
DIFF_DY = 0.01
RCP_DX = 1.0 / DIFF_DX
RCP_DY = 1.0 / DIFF_DY

PLANE_EPS = 1e-7

# Per-channel adaptive-sampling std thresholds (reference renderer.cpp:305).
SPP_THRESHOLD = (0.005, 0.001, 0.005)

# Luma weights (reference math/math.h ColorLuma).
LUMA_R = 0.2126
LUMA_G = 0.7152
LUMA_B = 0.0722

# Material model thresholds (reference MtlBlinn_*.cpp).
TOTAL_REFLECTION_THRESHOLD = 1.001
GLOSSINESS_VALUE_THRESHOLD = 0.001
COLOR_LUMA_THRESHOLD = 0.00001
REFRACTION_COLOR_THRESHOLD = 0.01
REFLECTION_COLOR_THRESHOLD = 0.01

# Russian-roulette absorption weight of the photon-map material
# (reference MtlBlinn_PhotonMap.cpp kill=0.1).
PHOTON_KILL = 0.1

# Default bounce budget (reference core/material.cpp:31, CLI -bounce).
DEFAULT_MAX_BOUNCE = 5

# Stochastic texture-footprint filter sample count (reference core/setup.h:38).
TEXTURE_SAMPLE_COUNT = 32
