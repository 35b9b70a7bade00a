"""Backgrounds: uniform / vertical gradient / equirect HDRI sky map.

Device representation is a single tagged struct; the tag is *static* so jit
specializes the miss shader per background kind (no wasted texture memory for
solid-color scenes).  Sampling semantics match lib/backgrounds.rs exactly,
including the reference's equirect conventions (theta = acos(-y),
phi = atan2(-z, x) + pi, nearest texel, x wrap, y flip —
lib/backgrounds.rs:84-93 + lib/utils/math.rs:24-29).

Unlike the reference's naive lookup, the sky map also carries a luminance CDF
for importance sampling (BASELINE.json config #4) — built host-side, used by
the (optional) NEE/importance-sampling integrator path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.pytree import pytree_dataclass, static_field
from ..utils import vec
from ..utils.types import PI

UNIFORM = 0
GRADIENT = 1
SKYMAP = 2


@pytree_dataclass
class Background:
    kind: int = static_field(default=UNIFORM)
    color_a: jnp.ndarray = None  # uniform color / gradient top    (3,)
    color_b: jnp.ndarray = None  # gradient bottom                 (3,)
    image: jnp.ndarray = None    # (H, W, 3) sky texture (SKYMAP only)
    # Marginal/conditional CDFs over luminance for importance sampling:
    cdf_rows: jnp.ndarray = None  # (H,) marginal CDF over rows
    cdf_cols: jnp.ndarray = None  # (H, W) conditional CDF per row
    path: str = static_field(default="")  # source path, for serialization

    # -- constructors -------------------------------------------------------
    @staticmethod
    def uniform(color) -> "Background":
        c = jnp.asarray(color, jnp.float32)
        return Background(kind=UNIFORM, color_a=c, color_b=c)

    @staticmethod
    def gradient(top, bottom) -> "Background":
        return Background(
            kind=GRADIENT,
            color_a=jnp.asarray(top, jnp.float32),
            color_b=jnp.asarray(bottom, jnp.float32),
        )

    @staticmethod
    def skymap_from_array(image: np.ndarray, path: str = "") -> "Background":
        image = np.asarray(image, np.float32)
        h, w, _ = image.shape
        # Luminance weighted by sin(theta) (solid-angle measure on the
        # equirect grid); rows are stored bottom-up per the reference's y flip.
        lum = image @ np.asarray([0.2126, 0.7152, 0.0722], np.float32)
        theta = (np.arange(h, dtype=np.float32) + 0.5) / h * np.pi
        weights = lum * np.sin(theta)[::-1, None] + 1e-12
        row_w = weights.sum(axis=1)
        cdf_rows = np.cumsum(row_w) / row_w.sum()
        cdf_cols = np.cumsum(weights, axis=1) / row_w[:, None]
        zero = jnp.zeros(3, jnp.float32)
        return Background(
            kind=SKYMAP, color_a=zero, color_b=zero,
            image=jnp.asarray(image),
            cdf_rows=jnp.asarray(cdf_rows),
            cdf_cols=jnp.asarray(cdf_cols),
            path=path,
        )

    @staticmethod
    def skymap(path: str) -> "Background":
        from ..io.exr import read_exr
        return Background.skymap_from_array(read_exr(path), path=path)

    # -- sampling -----------------------------------------------------------
    def sample(self, directions):
        """Miss-shader radiance for (..., 3) ray directions."""
        if self.kind == UNIFORM:
            return jnp.broadcast_to(self.color_a, directions.shape)
        if self.kind == GRADIENT:
            # Ray::vertical_grad (lib/utils/ray.rs:19-27)
            t = 0.5 * (vec.normalize(directions)[..., 1] + 1.0)
            return (
                self.color_a * (1.0 - t)[..., None]
                + self.color_b * t[..., None]
            )
        # SKYMAP: lib/backgrounds.rs:84-93
        h, w = self.image.shape[0], self.image.shape[1]
        sph = vec.to_spherical_coords(vec.normalize(directions))
        u = sph[..., 0] / PI
        v = sph[..., 1] / (2.0 * PI)
        x = jnp.mod(jnp.floor(v * w).astype(jnp.int32), w)
        y = (h - 1) - jnp.mod(jnp.floor(u * h).astype(jnp.int32), h)
        return self.image[y, x]

    def pdf(self, directions):
        """Solid-angle pdf of :func:`sample_skymap_direction` at the given
        (normalized) directions (SKYMAP only)."""
        h, w = self.image.shape[0], self.image.shape[1]
        sph = vec.to_spherical_coords(directions)
        theta = sph[..., 0]
        u = theta / PI
        v = sph[..., 1] / (2.0 * PI)
        x = jnp.mod(jnp.floor(v * w).astype(jnp.int32), w)
        iu = jnp.mod(jnp.floor(u * h).astype(jnp.int32), h)
        y = (h - 1) - iu
        p_row = self.cdf_rows - jnp.concatenate(
            [jnp.zeros(1), self.cdf_rows[:-1]]
        )
        p_col = self.cdf_cols - jnp.concatenate(
            [jnp.zeros((h, 1)), self.cdf_cols[:, :-1]], axis=1
        )
        p_texel = p_row[y] * p_col[y, x]
        sin_t = jnp.maximum(jnp.sin(theta), 1e-6)
        return p_texel * (h * w) / (2.0 * PI * PI * sin_t)

    # -- JSON ---------------------------------------------------------------
    def to_json(self) -> dict:
        rgb = lambda c: {"r": float(c[0]), "g": float(c[1]), "b": float(c[2])}
        if self.kind == UNIFORM:
            return {"type": "UniformBackground", "color": rgb(np.asarray(self.color_a))}
        if self.kind == GRADIENT:
            return {
                "type": "GradientBackground",
                "top": rgb(np.asarray(self.color_a)),
                "bottom": rgb(np.asarray(self.color_b)),
            }
        # The reference serializes the raw pixel vec; we serialize the source
        # path instead (human-sized JSON) with the raw form as a fallback.
        if not self.path:
            # array-built skymaps have no source path; fail HERE rather
            # than writing JSON from_json cannot load back
            raise ValueError(
                "SkyMap built from an in-memory array (no source path) "
                "is not JSON-serializable; construct it with "
                "Background.skymap(path) to keep scenes savable")
        return {"type": "SkyMap", "path": self.path,
                "width": int(self.image.shape[1]),
                "height": int(self.image.shape[0])}

    @staticmethod
    def from_json(d: dict) -> "Background":
        rgb = lambda o: (o["r"], o["g"], o["b"])
        t = d["type"]
        if t == "UniformBackground":
            return Background.uniform(rgb(d["color"]))
        if t == "GradientBackground":
            return Background.gradient(rgb(d["top"]), rgb(d["bottom"]))
        if t == "SkyMap":
            if "path" in d:
                return Background.skymap(d["path"])
            # reference-format: {"image": [colors...], "width": w, "height": h}
            img = np.asarray(
                [[c["r"], c["g"], c["b"]] for c in d["image"]], np.float32
            ).reshape(d["height"], d["width"], 3)
            return Background.skymap_from_array(img)
        raise ValueError(f"unknown background type {t!r}")


def sample_skymap_direction(bg: Background, u1, u2):
    """Importance-sample directions proportional to sky luminance x sin(theta).

    New capability over the reference (its SkyMap is lookup-only, SURVEY.md
    section 2.2): inverts the precomputed marginal/conditional CDFs, jitters
    uniformly inside the chosen texel, and returns (directions (...,3),
    solid-angle pdf (...,)).  Texel (y, x) maps to angles through the exact
    inverse of the reference's equirect lookup (lib/backgrounds.rs:84-93).
    """
    h, w = bg.image.shape[0], bg.image.shape[1]

    # invert the row marginal, reusing the remaining uniform mass as the
    # intra-texel jitter.  CDF inversion is a broadcast compare-and-count
    # (== searchsorted side="left": the count of entries < u IS the first
    # index with cdf >= u).  It costs O(R * W) per bounce; a binary search
    # would cost O(R * log W) (ROADMAP A7).
    y = jnp.clip(
        jnp.sum((bg.cdf_rows[None, :] < u1[:, None]).astype(jnp.int32),
                axis=1), 0, h - 1)
    cdf_lo = jnp.where(y > 0, bg.cdf_rows[jnp.maximum(y - 1, 0)], 0.0)
    p_row = bg.cdf_rows[y] - cdf_lo
    frac_y = jnp.clip((u1 - cdf_lo) / jnp.maximum(p_row, 1e-20), 0.0, 1.0)

    rows = bg.cdf_cols[y]
    x = jnp.clip(
        jnp.sum((rows < u2[:, None]).astype(jnp.int32), axis=1),
        0, w - 1)
    take = lambda idx: jnp.take_along_axis(rows, idx[:, None],
                                           axis=1)[:, 0]
    ccdf_lo = jnp.where(x > 0, take(jnp.maximum(x - 1, 0)), 0.0)
    p_col = take(x) - ccdf_lo
    frac_x = jnp.clip((u2 - ccdf_lo) / jnp.maximum(p_col, 1e-20), 0.0, 1.0)

    # texel -> angles (inverse of the reference lookup: y = h-1 - floor(u*h))
    iu = (h - 1) - y
    theta = (iu.astype(jnp.float32) + frac_y) * (PI / h)
    phi = (x.astype(jnp.float32) + frac_x) * (2.0 * PI / w)
    sin_t = jnp.sin(theta)
    d = jnp.stack(
        [
            sin_t * jnp.cos(phi - PI),
            -jnp.cos(theta),
            -sin_t * jnp.sin(phi - PI),
        ],
        axis=-1,
    )
    # pdf in solid-angle measure: P(texel) / (dtheta * dphi * sin(theta))
    pdf = (
        p_row * p_col * (h * w) / (2.0 * PI * PI)
        / jnp.maximum(sin_t, 1e-6)
    )
    return d, pdf
