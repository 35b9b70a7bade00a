"""Triangle meshes.

Array twin of ``Mesh`` (lib/core/mesh.rs:31-122): host-side NumPy
buffers that get flattened into the scene-wide SoA triangle arrays at build
time.  The reference keeps a *nested* BVH per mesh (lib/core/mesh.rs:119-122)
— we instead inline all triangles into one global flat BVH (SURVEY.md section
7 stage 2), which is the idiomatic layout for lockstep SIMD traversal.

Face normals follow the reference convention ``normalize(e2 x e1)`` with
e1 = v0 - v1, e2 = v2 - v1 (lib/core/mesh.rs:85-96).  Shading is flat: the
reference's vertex-normal interpolation is dead code (quirk Q6 — the
``angle > 0`` check replaces the interpolated normal with the face normal in
essentially all cases), so flat shading IS parity.  Smooth shading is offered
as an explicit opt-in extension.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..io.obj import load_obj


@dataclasses.dataclass
class Mesh:
    positions: np.ndarray   # (V, 3) f32
    normals: np.ndarray     # (V, 3) f32 vertex normals (smooth shading only)
    faces: np.ndarray       # (F, 3) i32
    material: int           # MaterialHandle
    smooth: bool = False    # opt-in smooth shading (reference flat-shades, Q6)
    path: str = ""          # source file, for serialization

    @staticmethod
    def from_file(path: str, material: int, smooth: bool = False) -> "Mesh":
        """Mesh::from_file (lib/core/mesh.rs:63-76)."""
        positions, normals, faces = load_obj(path)
        return Mesh(positions, normals, faces, material, smooth, path)

    @staticmethod
    def from_buffers(positions, normals, faces, material: int,
                     smooth: bool = False) -> "Mesh":
        return Mesh(
            np.asarray(positions, np.float32).reshape(-1, 3),
            np.asarray(normals, np.float32).reshape(-1, 3),
            np.asarray(faces, np.int32).reshape(-1, 3),
            material, smooth,
        )

    @property
    def num_triangles(self) -> int:
        return int(self.faces.shape[0])

    def triangle_soa(self):
        """-> (v0, e1mt, e2mt, face_normal) arrays, (F, 3) each.

        e1mt/e2mt are the Moller-Trumbore edges v1-v0, v2-v0
        (lib/core/mesh.rs:155-157); face_normal is the reference's
        ``(e2 x e1).normalize()`` with the *other* edge convention
        (lib/core/mesh.rs:85-96) — both definitions agree: e1, e2 there are
        v0-v1, v2-v1 and cross(e2, e1) == cross(v2-v0, v1-v0) flipped; we
        compute it directly from MT edges as normalize(cross(e2mt, e1mt)) * -1
        == normalize(cross(e1mt, e2mt)) negated appropriately.
        """
        v0 = self.positions[self.faces[:, 0]]
        v1 = self.positions[self.faces[:, 1]]
        v2 = self.positions[self.faces[:, 2]]
        e1 = v1 - v0
        e2 = v2 - v0
        # reference: normal = normalize((v2 - v1) x (v0 - v1))
        n = np.cross(v2 - v1, v0 - v1)
        norm = np.linalg.norm(n, axis=-1, keepdims=True)
        n = n / np.where(norm > 0, norm, 1.0)
        return (
            v0.astype(np.float32),
            e1.astype(np.float32),
            e2.astype(np.float32),
            n.astype(np.float32),
        )

    def bounds(self):
        """Mesh AABB over vertices (lib/core/mesh.rs:98-108)."""
        used = self.positions[self.faces.reshape(-1)]
        return used.min(axis=0), used.max(axis=0)
