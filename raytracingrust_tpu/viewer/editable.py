"""Type-driven property panels — the ``Editable`` trait, as data.

The reference implements ``Editable`` per type (Vec3 xyz drag rows, color
pickers for backgrounds, camera vectors + FoV slider — lib/gui/gui.rs:9-92)
and hand-builds the settings panel (spp slider 1..=10000, depth 1..=50,
clamp drag, mode combo, toggles — src/gui.rs:221-292).  Here the widgets are
*descriptions*: :func:`editable_schema` emits a JSON widget tree for a
``SceneBuilder``, the browser renders it generically, and
:func:`apply_edits` maps edited values back onto the builder.  Adding a new
material/background type extends the panel automatically, like implementing
the trait did in the reference.

Schema node: {"path": dotted key, "label": str, "widget": one of
slider|drag|color|vec3|combo|checkbox, widget-specific extras}.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from ..models import backgrounds as B
from ..models import materials as M
from ..models.camera import Camera
from ..models.scene import (
    MODE_CLAY,
    MODE_FULL,
    MODE_NORMAL,
    MODE_RANDOM,
    SceneBuilder,
)

MODES = [MODE_FULL, MODE_CLAY, MODE_NORMAL, MODE_RANDOM]


def _vec3(path: str, label: str) -> dict:
    # Editable for Vec3: three drag fields (lib/gui/gui.rs:15-24)
    return {"path": path, "label": label, "widget": "vec3", "speed": 0.1}


def _color(path: str, label: str) -> dict:
    return {"path": path, "label": label, "widget": "color"}


def _settings_schema() -> list[dict]:
    """The egui settings panel (src/gui.rs:221-292) as widget specs."""
    return [
        {"path": "settings.samples_per_pixel", "label": "Samples per pixel",
         "widget": "slider", "min": 1, "max": 10000, "log": True, "int": True},
        {"path": "settings.max_ray_depth", "label": "Max ray depth",
         "widget": "slider", "min": 1, "max": 50, "int": True},
        {"path": "settings.clamp_indirect", "label": "Clamp indirect",
         "widget": "drag", "speed": 0.1, "min": 0.0},
        {"path": "settings.mode", "label": "Render mode",
         "widget": "combo", "options": MODES},
        {"path": "settings.enable_bvh_tree", "label": "Enable BVH tree",
         "widget": "checkbox"},
        {"path": "settings.enable_multithreading",
         "label": "Enable multithreading (schema parity; the device is "
                  "always data-parallel)", "widget": "checkbox"},
        {"path": "settings.env_importance_sampling",
         "label": "Env importance sampling (MIS vs the HDRI sky; "
                  "beyond-reference)", "widget": "checkbox"},
    ]


def _camera_schema() -> list[dict]:
    """Editable for Camera (lib/gui/gui.rs:73-91)."""
    return [
        _vec3("camera.lookfrom", "Look from"),
        _vec3("camera.lookat", "Look at"),
        _vec3("camera.vertical", "Up"),
        {"path": "camera.vertical_fov", "label": "Vertical FoV",
         "widget": "slider", "min": 1.0, "max": 179.0},
    ]


def _background_schema(bg: B.Background) -> list[dict]:
    if bg.kind == B.UNIFORM:
        # Editable for UniformBackground (lib/gui/gui.rs:27-37)
        return [_color("background.color", "Background color")]
    if bg.kind == B.GRADIENT:
        # Editable for GradientBackground (lib/gui/gui.rs:40-60)
        return [_color("background.top", "Gradient top"),
                _color("background.bottom", "Gradient bottom")]
    # Editable for SkyMap is a no-op (lib/gui/gui.rs:63-66)
    return [{"path": "background.path", "label": f"Sky map: {bg.path}",
             "widget": "static"}]


def _material_schema(i: int, m: M.AnyMaterial, prefix: str = "") -> list[dict]:
    p = f"materials.{i}.{prefix}"
    name = type(m).__name__
    lbl = lambda s: f"[{i}] {prefix}{name}.{s}"
    if isinstance(m, M.Lambertian):
        return [_color(p + "albedo", lbl("albedo"))]
    if isinstance(m, M.Metal):
        return [_color(p + "albedo", lbl("albedo")),
                {"path": p + "fuzz", "label": lbl("fuzz"),
                 "widget": "slider", "min": 0.0, "max": 1.0}]
    if isinstance(m, M.Dielectric):
        return [{"path": p + "ir", "label": lbl("ir"),
                 "widget": "drag", "speed": 0.01, "min": 0.0}]
    if isinstance(m, M.Emission):
        return [_color(p + "color", lbl("color (premultiplied)"))]
    if isinstance(m, M.Isotropic):
        return [_color(p + "color", lbl("color"))]
    if isinstance(m, M.MixMaterial):
        out = [{"path": p + "factor", "label": lbl("factor"),
                "widget": "slider", "min": 0.0, "max": 1.0}]
        out += _material_schema(i, m.first, prefix=prefix + "first.")
        out += _material_schema(i, m.second, prefix=prefix + "second.")
        return out
    return []


def editable_schema(builder: SceneBuilder) -> dict:
    """Widget tree for the whole panel, grouped like the reference's
    collapsing sections (src/gui.rs:214-323)."""
    mats: list[dict] = []
    for i, m in enumerate(builder.materials):
        mats += _material_schema(i, m)
    return {
        "Render settings": _settings_schema(),
        "Camera": _camera_schema(),
        "Background": _background_schema(builder.background),
        "Materials": mats,
    }


# --------------------------------------------------------------- get / set

def _f3(a) -> list[float]:
    v = np.asarray(a, np.float64).reshape(-1)[:3]
    return [float(x) for x in v]


def _material_values(i: int, m: M.AnyMaterial, prefix: str = "") -> dict:
    p = f"materials.{i}.{prefix}"
    if isinstance(m, M.Lambertian):
        return {p + "albedo": _f3(m.albedo)}
    if isinstance(m, M.Metal):
        return {p + "albedo": _f3(m.albedo), p + "fuzz": float(m.fuzz)}
    if isinstance(m, M.Dielectric):
        return {p + "ir": float(m.ir)}
    if isinstance(m, (M.Emission, M.Isotropic)):
        return {p + "color": _f3(m.color)}
    if isinstance(m, M.MixMaterial):
        out = {p + "factor": float(m.factor)}
        out.update(_material_values(i, m.first, prefix=prefix + "first."))
        out.update(_material_values(i, m.second, prefix=prefix + "second."))
        return out
    return {}


def editable_values(builder: SceneBuilder) -> dict[str, Any]:
    """Current value for every schema path (flat dotted-key map)."""
    s = builder.settings
    cam: Camera = builder.camera
    bg = builder.background
    vals: dict[str, Any] = {
        "settings.samples_per_pixel": int(s.samples_per_pixel),
        "settings.max_ray_depth": int(s.max_ray_depth),
        "settings.clamp_indirect": float(s.clamp_indirect),
        "settings.mode": s.mode,
        "settings.enable_bvh_tree": bool(s.enable_bvh_tree),
        "settings.enable_multithreading": bool(s.enable_multithreading),
        "settings.env_importance_sampling": bool(s.env_importance_sampling),
        "camera.lookfrom": _f3(cam.lookfrom),
        "camera.lookat": _f3(cam.lookat),
        "camera.vertical": _f3(cam.vertical),
        "camera.vertical_fov": float(cam.vertical_fov),
    }
    if bg.kind == B.UNIFORM:
        vals["background.color"] = _f3(bg.color_a)
    elif bg.kind == B.GRADIENT:
        vals["background.top"] = _f3(bg.color_a)
        vals["background.bottom"] = _f3(bg.color_b)
    else:
        vals["background.path"] = bg.path
    for i, m in enumerate(builder.materials):
        vals.update(_material_values(i, m))
    return vals


def _set_material(m: M.AnyMaterial, parts: list[str], value):
    """Set one field on a (possibly nested mix) material, in place-ish:
    returns a replaced dataclass."""
    field = parts[0]
    if field in ("first", "second"):
        child = _set_material(getattr(m, field), parts[1:], value)
        return dataclasses.replace(m, **{field: child})
    if field in ("albedo", "color"):
        value = tuple(float(v) for v in value)
    else:
        value = float(value)
    return dataclasses.replace(m, **{field: value})


def apply_edits(builder: SceneBuilder, edits: dict[str, Any]) -> SceneBuilder:
    """Apply a flat {path: value} edit map onto the builder (mutates it)."""
    for path, value in edits.items():
        head, *rest = path.split(".")
        if head == "settings":
            (field,) = rest
            cur = getattr(builder.settings, field)
            if isinstance(cur, bool):
                value = bool(value)
            elif isinstance(cur, int):
                value = int(value)
            elif isinstance(cur, float):
                value = float(value)
            builder.settings = dataclasses.replace(
                builder.settings, **{field: value}
            )
        elif head == "camera":
            (field,) = rest
            import jax.numpy as jnp
            if field == "vertical_fov":
                v = jnp.asarray(float(value), jnp.float32)
            else:
                v = jnp.asarray([float(x) for x in value], jnp.float32)
            builder.camera = dataclasses.replace(builder.camera, **{field: v})
        elif head == "background":
            (field,) = rest
            bg = builder.background
            c = lambda v: tuple(float(x) for x in v)
            if bg.kind == B.UNIFORM and field == "color":
                builder.background = B.Background.uniform(c(value))
            elif bg.kind == B.GRADIENT and field == "top":
                builder.background = B.Background.gradient(
                    c(value), _f3(bg.color_b))
            elif bg.kind == B.GRADIENT and field == "bottom":
                builder.background = B.Background.gradient(
                    _f3(bg.color_a), c(value))
            # SkyMap: no editable fields (lib/gui/gui.rs:63-66)
        elif head == "materials":
            idx = int(rest[0])
            builder.materials[idx] = _set_material(
                builder.materials[idx], rest[1:], value
            )
        else:
            raise KeyError(f"unknown edit path {path!r}")
    return builder
