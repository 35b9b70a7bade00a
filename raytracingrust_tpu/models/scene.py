"""Scene model: SoA geometry pytree, authoring builder, JSON (de)serialization.

The reference owns ``Vec<Box<dyn Object>>`` + ``Vec<Box<dyn Material>>``
behind handle types (lib/core/scene.rs:33-110) and intersects via dynamic
dispatch.  Here the scene is one flat struct-of-arrays pytree living in
device memory:

  * all spheres in ``(N,)``-shaped arrays (solid spheres and constant-density
    volume spheres share the array, distinguished by ``neg_inv_density != 0``
    — the Volume wrapper of lib/volume.rs:19-73 collapses into per-row flags),
  * all mesh triangles inlined into global ``(T,)`` arrays (no nested per-mesh
    BVHs — SURVEY.md section 7 stage 2),
  * one material table (see materials.py),
  * a flat skip-link BVH over {spheres union triangles} built host-side.

JSON schema is byte-compatible with the reference's serde+typetag format
(lib/core/traits.rs:17-30), including the Q1 fix: ``clamp_indirect`` defaults
to 10.0 when missing (the two shipped scenes predate the field and the
reference panics on them — SURVEY.md section 3.3).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence

import jax.numpy as jnp
import numpy as np

from ..utils.pytree import pytree_dataclass, static_field
from .backgrounds import Background
from .camera import Camera
from .materials import (
    AnyMaterial,
    MaterialTable,
    build_table,
    material_from_json,
    material_to_json,
)
from .mesh import Mesh

# Render modes (lib/core/scene.rs:14-20)
MODE_FULL = "Full"
MODE_CLAY = "Clay"
MODE_RANDOM = "Random"
MODE_NORMAL = "Normal"


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """RenderSettings (lib/core/scene.rs:22-30) with the reference defaults
    (lib/core/scene.rs:52-65).  ``enable_multithreading`` is kept for schema
    parity; on the device everything is data-parallel regardless."""

    samples_per_pixel: int = 5
    max_ray_depth: int = 6
    clamp_indirect: float = 10.0
    enable_multithreading: bool = True
    enable_bvh_tree: bool = True
    mode: str = MODE_FULL
    # Beyond-reference capability (BASELINE config #4): importance-sample
    # the HDRI environment (one-sample MIS against BSDF sampling) instead
    # of relying on BSDF paths alone to find bright sky texels.  Off by
    # default = exact reference semantics (SkyMap lookup only,
    # lib/backgrounds.rs:84-93).
    env_importance_sampling: bool = False

    def to_json(self) -> dict:
        d = {
            "samples_per_pixel": self.samples_per_pixel,
            "max_ray_depth": self.max_ray_depth,
            "clamp_indirect": self.clamp_indirect,
            "enable_multithreading": self.enable_multithreading,
            "enable_bvh_tree": self.enable_bvh_tree,
            "mode": self.mode,
        }
        # keep byte-parity with reference scene files unless the
        # beyond-parity knob is actually on
        if self.env_importance_sampling:
            d["env_importance_sampling"] = True
        return d

    @staticmethod
    def from_json(d: dict) -> "RenderSettings":
        return RenderSettings(
            samples_per_pixel=int(d["samples_per_pixel"]),
            max_ray_depth=int(d["max_ray_depth"]),
            clamp_indirect=float(d.get("clamp_indirect", 10.0)),  # Q1 default
            enable_multithreading=bool(d.get("enable_multithreading", True)),
            enable_bvh_tree=bool(d.get("enable_bvh_tree", True)),
            mode=str(d.get("mode", MODE_FULL)),
            env_importance_sampling=bool(
                d.get("env_importance_sampling", False)),
        )


@pytree_dataclass
class SphereArray:
    """All spheres, volume-boundary spheres LAST (rows are partitioned at
    build time so each volume has a static ordinal for its RNG stream —
    the reference draws one uniform per Volume::hit, lib/volume.rs:57)."""

    center: jnp.ndarray           # (N, 3)
    radius: jnp.ndarray           # (N,)
    material: jnp.ndarray         # (N,) i32 MaterialHandle
    neg_inv_density: jnp.ndarray  # (N,) 0.0 = solid; else -1/density (volume)
    num_volumes: int = static_field(default=0)

    def __len__(self):
        return self.center.shape[0]

    @property
    def num_solid(self) -> int:
        return self.center.shape[0] - self.num_volumes


@pytree_dataclass
class TriangleArray:
    v0: jnp.ndarray        # (T, 3)
    e1: jnp.ndarray        # (T, 3) v1 - v0 (Moller-Trumbore edge)
    e2: jnp.ndarray        # (T, 3) v2 - v0
    normal: jnp.ndarray    # (T, 3) reference face normal (flat shading, Q6)
    material: jnp.ndarray  # (T,) i32
    # mesh-volume ordinal per triangle: -1 = ordinary surface triangle,
    # else the triangle bounds mesh volume #v (Volume::new over an
    # arbitrary Object, lib/volume.rs:25-31) and never shades as a surface
    volume: jnp.ndarray = None  # (T,) i32

    def __len__(self):
        return self.v0.shape[0]


@pytree_dataclass
class MeshVolumeTable:
    """Constant-density media bounded by triangle MESHES (the reference's
    ``Volume::new(Box<dyn Object>)`` with a Mesh boundary,
    lib/volume.rs:25-31).  Sphere-bounded volumes live in SphereArray;
    this table carries the mesh-bounded ones: per volume the medium's
    -1/density and the delegated (phase) material."""

    neg_inv_density: jnp.ndarray  # (V,)
    material: jnp.ndarray         # (V,) i32

    def __len__(self):
        return self.neg_inv_density.shape[0]


@pytree_dataclass
class FlatBVH:
    """The linearized BVH the reference left unfinished
    (``LinearBvhTree``, lib/core/bvh.rs:201-293, all commented out).

    DFS-ordered node array with skip links for stackless traversal:
      * ``hit_link[i]``  — next node when node i's AABB is hit
                           (its first child, or for leaves the skip link),
      * ``miss_link[i]`` — next node when missed (DFS skip over the subtree),
      * ``prim[i]``      — global primitive id for leaves, -1 for inner nodes.
    Global primitive ids: [0, N) spheres, [N, N+T) triangles.
    Traversal terminates at node index == num_nodes.
    """

    node_min: jnp.ndarray   # (K, 3)
    node_max: jnp.ndarray   # (K, 3)
    prim: jnp.ndarray       # (K,) i32
    hit_link: jnp.ndarray   # (K,) i32
    miss_link: jnp.ndarray  # (K,) i32
    depth: int = static_field(default=0)  # tree depth (static traversal bound)

    def __len__(self):
        return self.node_min.shape[0]


@pytree_dataclass
class Scene:
    camera: Camera
    background: Background
    spheres: SphereArray
    triangles: TriangleArray
    materials: MaterialTable
    bvh: Optional[FlatBVH]
    mesh_volumes: Optional[MeshVolumeTable] = None
    settings: RenderSettings = static_field(default=RenderSettings())

    @property
    def num_primitives(self) -> int:
        return len(self.spheres) + len(self.triangles)

    @property
    def num_mesh_volumes(self) -> int:
        return 0 if self.mesh_volumes is None else len(self.mesh_volumes)

    # -- persistence --------------------------------------------------------
    def save(self, path: str) -> None:
        """Serialize the DEVICE scene back to the reference JSON schema.

        Works for sphere/volume scenes — the reference itself panics on
        mesh serialization (lib/core/mesh.rs:40-60), and the device SoA
        keeps no mesh source paths, so triangle scenes raise here (keep
        the SceneBuilder around for those: ``SceneBuilder.save``)."""
        with open(path, "w") as f:
            json.dump(self.to_json(), f)

    def to_json(self) -> dict:
        """Device pytree -> reference-schema dict (round-trips through
        ``load_scene``; tests/test_forward_parity.py::test_scene_save)."""
        if len(self.triangles):
            raise ValueError(
                "mesh triangles are not JSON-serializable (the reference "
                "panics too, lib/core/mesh.rs:40-60) — keep the "
                "SceneBuilder for mesh scenes and use SceneBuilder.save")
        mats = self.materials
        kind = np.asarray(mats.kind)
        albedo = np.asarray(mats.albedo)
        fuzz = np.asarray(mats.fuzz)
        ir = np.asarray(mats.ir)
        emission = np.asarray(mats.emission)
        m1 = np.asarray(mats.mix_first)
        m2 = np.asarray(mats.mix_second)
        mf = np.asarray(mats.mix_factor)

        from .materials import (DIELECTRIC, EMISSION, ISOTROPIC, LAMBERTIAN,
                                METAL, MIX, Dielectric, Emission, Isotropic,
                                Lambertian, Metal, MixMaterial,
                                material_to_json)

        def mat(i: int):
            k = int(kind[i])
            if k == LAMBERTIAN:
                return Lambertian(tuple(albedo[i]))
            if k == METAL:
                return Metal(tuple(albedo[i]), float(fuzz[i]))
            if k == DIELECTRIC:
                return Dielectric(float(ir[i]))
            if k == EMISSION:
                return Emission(tuple(emission[i]))
            if k == ISOTROPIC:
                return Isotropic(tuple(albedo[i]))
            assert k == MIX
            return MixMaterial(mat(int(m1[i])), mat(int(m2[i])),
                               float(mf[i]))

        centers = np.asarray(self.spheres.center)
        radii = np.asarray(self.spheres.radius)
        smat = np.asarray(self.spheres.material)

        # serialize only the HANDLE rows (the full Vec the reference
        # serializes, lib/core/scene.rs:38 — including trailing materials
        # no object references); mix children live AFTER the handle rows
        # (build_table appends them) and appear inline inside their
        # parent's MixMaterial JSON only — emitting them standalone too
        # would re-append fresh child rows on every save->load cycle and
        # bloat the table monotonically
        n_handles = self.materials.num_handles
        if n_handles < 0:  # legacy table without the count: best effort
            n_handles = int(smat.max()) + 1 if smat.size else len(kind)
        materials = [material_to_json(mat(i)) for i in range(n_handles)]
        nid = np.asarray(self.spheres.neg_inv_density)
        objs = []
        for i in range(len(radii)):
            sphere = {
                "type": "Sphere",
                "center": {"x": float(centers[i, 0]),
                           "y": float(centers[i, 1]),
                           "z": float(centers[i, 2])},
                "radius": float(radii[i]),
                "material": int(smat[i]),
            }
            if nid[i] != 0.0:
                objs.append({"type": "Volume", "boundary": sphere,
                             "neg_inv_density": float(nid[i])})
            else:
                objs.append(sphere)
        return {
            "camera": self.camera.to_json(),
            "settings": self.settings.to_json(),
            "background": self.background.to_json(),
            "objects": objs,
            "materials": materials,
        }


class SceneBuilder:
    """Host-side authoring API mirroring the reference Scene's
    add_object/add_material handle workflow (lib/core/scene.rs:88-110),
    finalized into the device SoA pytree with ``build()``."""

    def __init__(self):
        self.camera = Camera.default()
        self.settings = RenderSettings()
        self.background = Background.uniform((0.8, 0.8, 0.8))  # default bg
        self.materials: list[AnyMaterial] = []
        # object records, in insertion order (for serialization parity)
        self.objects: list[dict] = []

    # -- authoring ----------------------------------------------------------
    def add_material(self, material: AnyMaterial) -> int:
        """-> MaterialHandle (lib/core/scene.rs:96-99)."""
        self.materials.append(material)
        return len(self.materials) - 1

    def add_sphere(self, center, radius: float, material: int) -> int:
        self.objects.append({
            "kind": "sphere", "center": tuple(center),
            "radius": float(radius), "material": int(material),
        })
        return len(self.objects) - 1

    def add_mesh(self, mesh: Mesh) -> int:
        self.objects.append({"kind": "mesh", "mesh": mesh})
        return len(self.objects) - 1

    def add_volume(self, boundary_index: int, density: float) -> int:
        """Wrap a previously added object in a constant-density medium
        (``Volume::new`` accepts ANY Object, lib/volume.rs:25-31): sphere
        OR mesh boundaries.  The boundary stops being a solid surface and
        becomes the medium boundary; its material delegates as the phase
        material."""
        rec = self.objects[boundary_index]
        if rec["kind"] not in ("sphere", "mesh"):
            raise ValueError("volume boundary must be a sphere or mesh")
        rec["neg_inv_density"] = -1.0 / float(density)
        return boundary_index

    # -- build --------------------------------------------------------------
    def build(self, with_bvh: Optional[bool] = None) -> Scene:
        f32, i32 = np.float32, np.int32
        centers, radii, smats, nids = [], [], [], []
        tv0, te1, te2, tn, tmats, tvols = [], [], [], [], [], []
        mv_nid, mv_mat = [], []
        for rec in self.objects:
            if rec["kind"] == "sphere":
                centers.append(rec["center"])
                radii.append(rec["radius"])
                smats.append(rec["material"])
                nids.append(rec.get("neg_inv_density", 0.0))
            elif rec["kind"] == "mesh":
                mesh: Mesh = rec["mesh"]
                v0, e1, e2, n = mesh.triangle_soa()
                tv0.append(v0); te1.append(e1); te2.append(e2); tn.append(n)
                tmats.append(np.full(len(v0), mesh.material, i32))
                nid = rec.get("neg_inv_density", 0.0)
                if nid != 0.0:
                    # mesh-bounded constant-density volume: its triangles
                    # carry the volume ordinal and never shade as surfaces
                    tvols.append(np.full(len(v0), len(mv_nid), i32))
                    mv_nid.append(nid)
                    mv_mat.append(mesh.material)
                else:
                    tvols.append(np.full(len(v0), -1, i32))

        centers = np.asarray(centers, f32).reshape(-1, 3)
        radii = np.asarray(radii, f32)
        smats = np.asarray(smats, i32)
        nids = np.asarray(nids, f32)
        # stable-partition: solid spheres first, volume boundaries last
        order = np.argsort(nids != 0.0, kind="stable")
        num_volumes = int(np.count_nonzero(nids != 0.0))
        spheres = SphereArray(
            center=jnp.asarray(centers[order]),
            radius=jnp.asarray(radii[order]),
            material=jnp.asarray(smats[order]),
            neg_inv_density=jnp.asarray(nids[order]),
            num_volumes=num_volumes,
        )
        cat = lambda xs, d: (
            np.concatenate(xs, axis=0) if xs else np.zeros((0,) + d, f32)
        )
        triangles = TriangleArray(
            v0=jnp.asarray(cat(tv0, (3,))),
            e1=jnp.asarray(cat(te1, (3,))),
            e2=jnp.asarray(cat(te2, (3,))),
            normal=jnp.asarray(cat(tn, (3,))),
            material=jnp.asarray(
                np.concatenate(tmats) if tmats else np.zeros(0, i32)
            ),
            volume=jnp.asarray(
                np.concatenate(tvols) if tvols else np.zeros(0, i32)
            ),
        )
        mesh_volumes = None
        if mv_nid:
            mesh_volumes = MeshVolumeTable(
                neg_inv_density=jnp.asarray(mv_nid, jnp.float32),
                material=jnp.asarray(mv_mat, jnp.int32),
            )

        if with_bvh is None:
            with_bvh = self.settings.enable_bvh_tree
        bvh = None
        if with_bvh:
            from ..ops.bvh import build_bvh
            bvh = build_bvh(spheres, triangles)

        return Scene(
            camera=self.camera,
            background=self.background,
            spheres=spheres,
            triangles=triangles,
            materials=build_table(self.materials),
            bvh=bvh,
            mesh_volumes=mesh_volumes,
            settings=self.settings,
        )

    # -- JSON ---------------------------------------------------------------
    def to_json(self) -> dict:
        objs = []
        for rec in self.objects:
            if rec["kind"] == "sphere":
                sphere = {
                    "type": "Sphere",
                    "center": {"x": rec["center"][0], "y": rec["center"][1],
                               "z": rec["center"][2]},
                    "radius": rec["radius"],
                    "material": rec["material"],
                }
                if rec.get("neg_inv_density", 0.0) != 0.0:
                    objs.append({
                        "type": "Volume", "boundary": sphere,
                        "neg_inv_density": rec["neg_inv_density"],
                    })
                else:
                    objs.append(sphere)
            elif rec["kind"] == "mesh":
                mesh: Mesh = rec["mesh"]
                # The reference PANICS on mesh serialization
                # (lib/core/mesh.rs:40-60).  We serialize the source path —
                # a strict superset of the reference schema.
                entry = {"type": "Mesh", "path": mesh.path,
                         "material": mesh.material,
                         "smooth": mesh.smooth}
                if rec.get("neg_inv_density", 0.0) != 0.0:
                    objs.append({
                        "type": "Volume", "boundary": entry,
                        "neg_inv_density": rec["neg_inv_density"],
                    })
                else:
                    objs.append(entry)
        return {
            "camera": self.camera.to_json(),
            "settings": self.settings.to_json(),
            "background": self.background.to_json(),
            "objects": objs,
            "materials": [material_to_json(m) for m in self.materials],
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)

    @staticmethod
    def from_json(d: dict) -> "SceneBuilder":
        b = SceneBuilder()
        b.camera = Camera.from_json(d["camera"])
        b.settings = RenderSettings.from_json(d["settings"])
        b.background = Background.from_json(d["background"])
        b.materials = [material_from_json(m) for m in d["materials"]]

        def add_object(o: dict, neg_inv_density: float = 0.0):
            t = o["type"]
            if t == "Sphere":
                c = o["center"]
                b.objects.append({
                    "kind": "sphere",
                    "center": (c["x"], c["y"], c["z"]),
                    "radius": float(o["radius"]),
                    "material": int(o["material"]),
                    "neg_inv_density": neg_inv_density,
                })
            elif t == "Volume":
                add_object(o["boundary"],
                           neg_inv_density=float(o["neg_inv_density"]))
            elif t == "Mesh":
                b.objects.append({
                    "kind": "mesh",
                    "mesh": Mesh.from_file(o["path"], int(o["material"]),
                                           bool(o.get("smooth", False))),
                    "neg_inv_density": neg_inv_density,
                })
            else:
                raise ValueError(f"unknown object type {t!r}")

        for o in d["objects"]:
            add_object(o)
        return b

    # alias used by Scene.save
    from_scene_json = from_json

    @staticmethod
    def from_file(path: str) -> "SceneBuilder":
        """Scene::from_file (lib/core/scene.rs:74-76), without the unwrap."""
        with open(path) as f:
            return SceneBuilder.from_json(json.load(f))


def load_scene(path: str, with_bvh: Optional[bool] = None) -> Scene:
    return SceneBuilder.from_file(path).build(with_bvh=with_bvh)
