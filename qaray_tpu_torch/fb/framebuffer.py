"""Host-side framebuffer: accumulation planes + debug images + PNG output.

Mirrors the reference FrameBuffer (fb/framebuffer.{h,cpp}): color, z-buffer,
per-pixel sample count, MPI-style mask plane, plus the min-max-normalized
z / sample-count visualization images (framebuffer.cpp:62-107) and the
Renderer_GUI output file names (Renderer_GUI.cpp:65-73).

Accumulation uses the reference's exact incremental mean + std recurrence
(SuperSamplerHalton::Accumulate, scene/scene.cpp:113-123) so adaptive
sampling stops at the same per-pixel sample counts.
"""

from __future__ import annotations

import numpy as np

from qaray_tpu_torch.core.constants import BIGFLOAT


def linear_to_srgb_np(c: np.ndarray) -> np.ndarray:
    a = 0.055
    return np.where(
        c < 0.0031308,
        12.92 * c,
        (1.0 + a) * np.power(np.maximum(c, 1e-12), 1.0 / 2.4) - a,
    )


class FrameBuffer:
    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        n = width * height
        self.mean = np.zeros((n, 3), np.float32)
        self.color_std = np.zeros((n, 3), np.float32)
        self.count = np.zeros((n,), np.int32)
        self.zbuffer = np.full((n,), BIGFLOAT, np.float32)
        self.mask = np.zeros((n,), np.uint8)
        self.img = np.zeros((n, 3), np.uint8)
        # Irradiance-computation debug plane (fb/framebuffer.h:42
        # irradComp + SaveIrradianceComputationImage, GUI view mode 5).
        # The reference allocates and displays it but no material ever
        # writes it; here the photon-map integrator marks pixels whose
        # primary vertex is a photon-gather (diffuse) surface.
        self.irrad = np.zeros((n,), np.uint8)
        self.num_rendered_pixels = 0

    # -- accumulation ---------------------------------------------------------

    def accumulate(self, pixel_ids: np.ndarray, colors: np.ndarray):
        """One new sample for each pixel id (ids unique within a call).

        Exact port of the Welford-style recurrence at scene/scene.cpp:113-123:
            dc   = (x - mean) / (s + 1)
            mean += dc
            std  += s > 0 ? dc^2 * (s+1) - std / s : 0
        """
        s = self.count[pixel_ids].astype(np.float32)[:, None]
        dc = (colors - self.mean[pixel_ids]) / (s + 1.0)
        self.mean[pixel_ids] += dc
        upd = dc * dc * (s + 1.0) - self.color_std[pixel_ids] / np.maximum(s, 1.0)
        self.color_std[pixel_ids] += np.where(s > 0, upd, 0.0)
        self.count[pixel_ids] += 1

    def set_depth(self, pixel_ids: np.ndarray, depth: np.ndarray):
        self.zbuffer[pixel_ids] = depth

    def mark_irradiance(self, pixel_ids: np.ndarray, mask: np.ndarray):
        """Mark pixels that performed an irradiance (photon-gather) estimate."""
        self.irrad[pixel_ids] = np.maximum(
            self.irrad[pixel_ids], np.where(mask, 255, 0).astype(np.uint8)
        )

    def probe(self, x: int, y: int):
        """Per-pixel probe: (r, g, b, z) at integer pixel coordinates.

        The GUI's left-click PrintPixelData equivalent
        (renderers/gui/viewport.cpp:516-527); returns the quantized color
        bytes and the z-buffer value. Raises IndexError outside the image.
        """
        if not (0 <= x < self.width and 0 <= y < self.height):
            raise IndexError(f"-- Invalid pixel ({x},{y}) --")
        i = y * self.width + x
        r, g, b = (int(v) for v in self.img[i])
        return r, g, b, float(self.zbuffer[i])

    def converged(self, threshold) -> np.ndarray:
        """Per-pixel adaptive stop test (scene/scene.cpp:92-97 negated)."""
        th = np.asarray(threshold, np.float32)
        return ~np.any(self.color_std > th[None, :], axis=-1)

    # -- finalize -------------------------------------------------------------

    def finalize(self, use_srgb: bool, spp_max: int):
        """Quantize color plane (renderer.cpp:347-365)."""
        c = self.mean.copy()
        if use_srgb:
            c = linear_to_srgb_np(c)
        c = np.clip(c, 0.0, 1.0)
        self.img = np.round(c * 255.0).astype(np.uint8)
        self.sample_count_u8 = np.clip(
            255.0 * self.count / float(max(spp_max, 1)), 0, 255
        ).astype(np.uint8)
        self.mask[:] = 1
        return self.img

    # -- debug planes (framebuffer.cpp:62-107) --------------------------------

    def z_image(self) -> np.ndarray:
        z = self.zbuffer
        valid = z < BIGFLOAT
        out = np.zeros_like(z, np.uint8)
        if valid.any():
            zmin = z[valid].min()
            zmax = z[valid].max()
            f = (zmax - z) / max(zmax - zmin, 1e-20)
            out = np.where(valid, np.clip(f * 255, 0, 255), 0).astype(np.uint8)
        return out

    def sample_count_image(self) -> np.ndarray:
        s = self.sample_count_u8
        smin, smax = int(s.min()), int(s.max())
        if smax == smin:
            return np.zeros_like(s)
        return ((255 * (s.astype(np.int32) - smin)) // (smax - smin)).astype(np.uint8)

    # -- checkpoint / resume --------------------------------------------------
    # The reference has no render checkpointing (SURVEY.md §5); chunked
    # sample rounds give natural granularity here: the accumulator state
    # (mean/std/count/z) is the complete resume point.

    def save_state(self, path: str):
        np.savez_compressed(
            path,
            width=self.width,
            height=self.height,
            mean=self.mean,
            color_std=self.color_std,
            count=self.count,
            zbuffer=self.zbuffer,
        )

    @classmethod
    def load_state(cls, path: str) -> "FrameBuffer":
        data = np.load(path)
        fb = cls(int(data["width"]), int(data["height"]))
        fb.mean = data["mean"]
        fb.color_std = data["color_std"]
        fb.count = data["count"]
        fb.zbuffer = data["zbuffer"]
        return fb

    # -- IO -------------------------------------------------------------------

    def _reshape(self, a):
        return a.reshape(self.height, self.width, -1).squeeze()

    def save_png(self, filename: str, data: np.ndarray):
        from qaray_tpu_torch.fb.png import write_png

        write_png(filename, self._reshape(data))

    def save_image(self, filename: str):
        self.save_png(filename, self.img)

    def save_z_image(self, filename: str):
        self.save_png(filename, self.z_image())

    def save_sample_count_image(self, filename: str):
        self.save_png(filename, self.sample_count_image())

    def save_irradiance_image(self, filename: str):
        """SaveIrradianceComputationImage (fb/framebuffer.cpp:140-143)."""
        self.save_png(filename, self.irrad)
