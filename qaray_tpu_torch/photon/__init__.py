"""Photon maps: build (build.py), clustered tables for the gather kernels
(cluster.py) and the exact irradiance estimate (gather.py)."""
