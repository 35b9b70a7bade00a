"""Materials: authoring classes + the device-side SoA material table.

The reference dispatches ``Box<dyn Material>::scatter`` per hit
(lib/core/render.rs:40 -> lib/materials.rs).  Dynamic dispatch does not
vectorize over a ray wavefront, so all materials live in ONE struct-of-arrays table and the shader
evaluates every lobe branchlessly, blending by a one-hot mask over the kind id
(the "expert parallel" analog from SURVEY.md section 2.6).

``MixMaterial`` (lib/materials.rs:141-157) nests boxed materials; we flatten
nested children into extra table rows and store child *indices* — a mix hit
resolves its effective material id with a couple of masked gathers before lobe
evaluation (mix-of-mix supported up to MAX_MIX_DEPTH).

Emission stores the premultiplied color exactly as the reference serializes it
(``Emission::new`` premultiplies strength at construction,
lib/materials.rs:78-84).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax.numpy as jnp
import numpy as np

from ..utils.pytree import pytree_dataclass, static_field

# Material kind ids (order is part of the on-device format).
LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2
EMISSION = 3
ISOTROPIC = 4
MIX = 5

MAX_MIX_DEPTH = 4  # static bound on mix-of-mix nesting


# ------------------------------------------------------------- authoring API

@dataclasses.dataclass
class Lambertian:
    """lib/materials.rs:18-42."""
    albedo: tuple


@dataclasses.dataclass
class Metal:
    """lib/materials.rs:44-71."""
    albedo: tuple
    fuzz: float = 0.0


@dataclasses.dataclass
class Dielectric:
    """lib/materials.rs:93-139."""
    ir: float


@dataclasses.dataclass
class Emission:
    """lib/materials.rs:73-91 — ``color`` is already strength-premultiplied."""
    color: tuple

    @staticmethod
    def create(color, strength: float) -> "Emission":
        return Emission(tuple(c * strength for c in color))


@dataclasses.dataclass
class Isotropic:
    """Volume phase material (lib/volume.rs:75-88)."""
    color: tuple


@dataclasses.dataclass
class MixMaterial:
    """Stochastic blend; ``factor`` is the probability of ``second``
    (lib/materials.rs:149-156: U >= factor -> first)."""
    first: "AnyMaterial"
    second: "AnyMaterial"
    factor: float


AnyMaterial = Lambertian | Metal | Dielectric | Emission | Isotropic | MixMaterial


# --------------------------------------------------------------- SoA table

@pytree_dataclass
class MaterialTable:
    kind: jnp.ndarray        # (M,) i32
    albedo: jnp.ndarray      # (M, 3) lambertian/metal/isotropic attenuation
    fuzz: jnp.ndarray        # (M,)
    ir: jnp.ndarray          # (M,)
    emission: jnp.ndarray    # (M, 3) premultiplied emission color
    mix_first: jnp.ndarray   # (M,) i32 child index (self if not a mix)
    mix_second: jnp.ndarray  # (M,) i32
    mix_factor: jnp.ndarray  # (M,)
    # static so jit skips mix resolution (and its gathers + uniform draws)
    # entirely for mix-free scenes
    has_mix: bool = static_field(default=False)
    # static set of material kinds present: the shader compiles only the
    # lobes a scene actually uses (e.g. no cbrt unless an Isotropic exists)
    kinds_present: tuple = static_field(default=(0, 1, 2, 3, 4))
    # number of HANDLE rows (the reference's Vec<Box<dyn Material>> length,
    # lib/core/scene.rs:38): rows [0, num_handles) are addressable by
    # objects; mix-child rows live after.  Serialization emits exactly
    # these rows — including trailing materials no object references
    # (-1 = legacy tables built before this field; fall back to max+1)
    num_handles: int = static_field(default=-1)

    def __len__(self):
        return self.kind.shape[0]


def build_table(materials: Sequence[AnyMaterial]) -> MaterialTable:
    """Flatten authoring materials (incl. nested mixes) into a table.

    The first ``len(materials)`` rows keep their handle index, matching the
    reference's ``MaterialHandle(usize)`` semantics (lib/core/scene.rs:67-71);
    mix children are appended after.
    """
    rows: list[dict] = []

    def blank():
        return dict(kind=LAMBERTIAN, albedo=(0.0, 0.0, 0.0), fuzz=0.0, ir=1.0,
                    emission=(0.0, 0.0, 0.0), mix_first=0, mix_second=0,
                    mix_factor=0.0)

    def emit(m: AnyMaterial, slot: int) -> None:
        row = rows[slot]
        if isinstance(m, Lambertian):
            row.update(kind=LAMBERTIAN, albedo=tuple(m.albedo))
        elif isinstance(m, Metal):
            row.update(kind=METAL, albedo=tuple(m.albedo), fuzz=float(m.fuzz))
        elif isinstance(m, Dielectric):
            row.update(kind=DIELECTRIC, ir=float(m.ir))
        elif isinstance(m, Emission):
            row.update(kind=EMISSION, emission=tuple(m.color))
        elif isinstance(m, Isotropic):
            row.update(kind=ISOTROPIC, albedo=tuple(m.color))
        elif isinstance(m, MixMaterial):
            first = alloc(m.first)
            second = alloc(m.second)
            row.update(kind=MIX, mix_first=first, mix_second=second,
                       mix_factor=float(m.factor))
        else:
            raise TypeError(f"unknown material {m!r}")
        # non-mix rows point at themselves so the resolve loop is a no-op
        if row["kind"] != MIX:
            row["mix_first"] = slot
            row["mix_second"] = slot

    def alloc(m: AnyMaterial) -> int:
        slot = len(rows)
        rows.append(blank())
        emit(m, slot)
        return slot

    for i, m in enumerate(materials):
        rows.append(blank())
    if not rows:  # empty scene: one dummy lambertian row keeps shapes nonzero
        rows.append(blank())
        rows[0]["mix_first"] = rows[0]["mix_second"] = 0
    for i, m in enumerate(materials):
        emit(m, i)

    f32 = np.float32
    return MaterialTable(
        num_handles=len(materials),
        has_mix=any(r["kind"] == MIX for r in rows),
        kinds_present=tuple(sorted({r["kind"] for r in rows} - {MIX})),
        kind=jnp.asarray([r["kind"] for r in rows], jnp.int32),
        albedo=jnp.asarray([r["albedo"] for r in rows], f32),
        fuzz=jnp.asarray([r["fuzz"] for r in rows], f32),
        ir=jnp.asarray([r["ir"] for r in rows], f32),
        emission=jnp.asarray([r["emission"] for r in rows], f32),
        mix_first=jnp.asarray([r["mix_first"] for r in rows], jnp.int32),
        mix_second=jnp.asarray([r["mix_second"] for r in rows], jnp.int32),
        mix_factor=jnp.asarray([r["mix_factor"] for r in rows], f32),
    )


# ----------------------------------------------------------------- JSON IO

def material_to_json(m: AnyMaterial) -> dict:
    """Reference typetag schema (e.g. lib/materials.rs:29 tags)."""
    rgb = lambda c: {"r": float(c[0]), "g": float(c[1]), "b": float(c[2])}
    if isinstance(m, Lambertian):
        return {"type": "Lambertian", "albedo": rgb(m.albedo)}
    if isinstance(m, Metal):
        return {"type": "Metal", "albedo": rgb(m.albedo), "fuzz": float(m.fuzz)}
    if isinstance(m, Dielectric):
        return {"type": "Dielectric", "ir": float(m.ir)}
    if isinstance(m, Emission):
        return {"type": "Emission", "color": rgb(m.color)}
    if isinstance(m, Isotropic):
        return {"type": "Isotropic", "color": rgb(m.color)}
    if isinstance(m, MixMaterial):
        return {
            "type": "MixMaterial",
            "first": material_to_json(m.first),
            "second": material_to_json(m.second),
            "factor": float(m.factor),
        }
    raise TypeError(f"unknown material {m!r}")


def material_from_json(d: dict) -> AnyMaterial:
    rgb = lambda o: (o["r"], o["g"], o["b"])
    t = d["type"]
    if t == "Lambertian":
        return Lambertian(rgb(d["albedo"]))
    if t == "Metal":
        return Metal(rgb(d["albedo"]), d["fuzz"])
    if t == "Dielectric":
        return Dielectric(d["ir"])
    if t == "Emission":
        return Emission(rgb(d["color"]))
    if t == "Isotropic":
        return Isotropic(rgb(d["color"]))
    if t == "MixMaterial":
        return MixMaterial(
            material_from_json(d["first"]),
            material_from_json(d["second"]),
            d["factor"],
        )
    raise ValueError(f"unknown material type {t!r}")
