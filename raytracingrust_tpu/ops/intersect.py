"""Ray/primitive intersection, formulated as dense matmuls.

The reference intersects one ray against one primitive at a time through
dynamic dispatch (Sphere::hit lib/objects.rs:22-51, Triangle::hit
Moller-Trumbore lib/core/mesh.rs:146-197).  Here a whole wavefront of R rays
tests all N primitives at once, and every
bilinear term of both intersection tests is a matmul:

  * sphere:    half_b and the quadratic constant need  d.c  and  o.c  over
               all (ray, sphere) pairs -> (R,3) @ (3,N);
  * triangle:  every Moller-Trumbore determinant is a scalar triple product,
               i.e. bilinear in the ray basis (o, d, w = o x d) and a
               precomputed per-triangle constant vector:
                   a     = -d.n                 with n = e1 x e2
                   u*a   =  w.e2 + d.(v0 x e2)
                   v*a   = -(w.e1 + d.(v0 x e1))
                   t*a   =  o.n - v0.n
               -> six (R,3) @ (3,T) matmuls, everything else elementwise.

All matmuls run at Precision.HIGHEST (f32 intersection math; bf16 loses hits
to cancellation).  Quirk ledger: we honor tmax and use a proper determinant
epsilon in the triangle test (fixes Q5); normals are flat face normals (Q6 —
that IS the reference behavior, its smooth-shading path is dead code).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils import vec
from ..utils.lookup import tgather
from ..utils.pytree import pytree_dataclass
from ..utils.types import INF, T_MIN

# determinant epsilon for the triangle test (reference used tmin=1e-5, Q5)
TRI_DET_EPS = 1e-8


@pytree_dataclass
class Hit:
    """Batched HitRecord (lib/utils/ray.rs:29-55).  ``prim`` is the global
    primitive id ([0,N) spheres, [N,N+T) triangles), -1 on miss."""

    t: jnp.ndarray           # (R,)
    prim: jnp.ndarray        # (R,) i32
    material: jnp.ndarray    # (R,) i32
    point: jnp.ndarray       # (R, 3)
    normal: jnp.ndarray      # (R, 3) front-face-flipped, as HitRecord::new
    front_face: jnp.ndarray  # (R,) bool

    @property
    def hit(self):
        return self.prim >= 0


def _dotT(a, b):
    """(R, 3) @ (3, N) at HIGHEST precision -> (R, N)."""
    return jnp.dot(a, b.T, precision=jax.lax.Precision.HIGHEST)


# --- compensated f32 (Dekker/Veltkamp, no fma needed) -----------------------
#
# The expanded sphere quadratic needs the PER-SPHERE constant
# cc_rr = |c|^2 - r^2.  Naive f32 rounds |c|^2 at |c|^2 * eps — ~6e-4
# absolute for the RTiOW ground sphere (|c| ~ 100.5, r = 100) — a CONSTANT
# bias that lands exactly at the t ~ tmin = 1e-5 self-intersection decision
# scale once a bounced ray re-tests its own sphere.  That bias
# systematically shifts the dense path's escape rate vs the
# direct-form kernels — background/albedo gradients disagreed by 7x the
# Monte-Carlo reseed noise.  Computing the constant with exact two-products
# and two-sums (costs a handful of ops per SPHERE, not per ray) removes
# the bias; the remaining per-ray terms only round at |o||c| * eps ~ 1e-5.

def _split_f32(x):
    """Veltkamp split: x == hi + lo with 12-bit-mantissa halves (exact)."""
    c = x * jnp.float32(4097.0)  # 2^12 + 1
    hi = c - (c - x)
    return hi, x - hi


def _two_prod(x, y):
    """(p, e) with p = fl(x*y) and p + e == x*y exactly."""
    p = x * y
    xh, xl = _split_f32(x)
    yh, yl = _split_f32(y)
    e = ((xh * yh - p) + xh * yl + xl * yh) + xl * yl
    return p, e


def _two_sum(a, b):
    """(s, e) with s = fl(a+b) and s + e == a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _cc_rr_compensated(center, radius):
    """|c|^2 - r^2 as a (hi, lo) f32 pair accurate to ~|result| * eps."""
    s0, e0 = _two_prod(center[:, 0], center[:, 0])
    s1, e1 = _two_prod(center[:, 1], center[:, 1])
    s2, e2 = _two_prod(center[:, 2], center[:, 2])
    rr, er = _two_prod(radius, radius)
    t01, g01 = _two_sum(s0, s1)
    t012, g012 = _two_sum(t01, s2)
    hi, g_r = _two_sum(t012, -rr)
    lo = ((e0 + e1 + e2) - er) + ((g01 + g012) + g_r)
    return hi, lo


# ------------------------------------------------------------------ spheres

def sphere_ts(spheres, o, d, u_vol, tmin, tmax):
    """All-pairs sphere hit distances -> (R, N) with +inf for misses.

    Solid spheres follow Sphere::hit (lib/objects.rs:22-51): nearest root in
    [tmin, tmax], else the far root.  Volume-boundary spheres follow
    Volume::hit (lib/volume.rs:35-73): exponential free flight between the
    two boundary roots.  ``u_vol`` is (R, num_volumes) U[0,1) draws (the
    reference draws one per Volume::hit call, lib/volume.rs:57).
    """
    n = spheres.center.shape[0]
    r_ = spheres.radius

    a = vec.length_squared(d)[:, None]                        # (R, 1)
    # half_b = (o - c).d = o.d - c.d ; c_quad = |o-c|^2 - r^2
    od = vec.dot(o, d)[:, None]                               # (R, 1)
    cd = _dotT(d, spheres.center)                             # (R, N)
    oc = _dotT(o, spheres.center)                             # (R, N)
    oo = vec.length_squared(o)[:, None]                       # (R, 1)
    # per-sphere constant in COMPENSATED f32: the naive form's constant
    # rounding bias systematically flips t~tmin self-intersections
    # (see _cc_rr_compensated)
    cc_hi, cc_lo = _cc_rr_compensated(spheres.center, r_)     # (N,), (N,)

    half_b = od - cd
    c_quad = (oo - 2.0 * oc + cc_hi[None, :]) + cc_lo[None, :]
    disc = half_b * half_b - a * c_quad
    ok = disc >= 0.0
    # double-where: sqrt'(0) = inf would poison reverse-mode AD on the
    # rejected (disc < 0) lanes via 0 * inf = nan
    sqrtd = jnp.sqrt(jnp.where(ok, disc, 1.0))
    sqrtd = jnp.where(ok, sqrtd, 0.0)
    inv_a = 1.0 / a
    t1 = (-half_b - sqrtd) * inv_a  # near root
    t2 = (-half_b + sqrtd) * inv_a  # far root

    # --- solid path (lib/objects.rs:38-45): near root if in range, else far
    in1 = (t1 >= tmin) & (t1 <= tmax)
    in2 = (t2 >= tmin) & (t2 <= tmax)
    t_solid = jnp.where(in1, t1, jnp.where(in2, t2, INF))
    t_solid = jnp.where(ok, t_solid, INF)

    nv = spheres.num_volumes
    if nv == 0:
        return t_solid

    # --- volume path (lib/volume.rs:35-73), for the last nv columns only.
    ns = spheres.num_solid
    t1v, t2v = t1[:, ns:], t2[:, ns:]
    okv = ok[:, ns:]
    # hit1 = boundary hit on (-inf, inf) -> near root; hit2 = boundary hit on
    # (hit1 + tmin, inf) -> far root (near root never >= itself + tmin)
    h1 = t1v
    h2 = jnp.where(t2v >= t1v + tmin, t2v, INF)
    h1 = jnp.maximum(h1, tmin)      # if hit1.t < tmin { hit1.t = tmin }
    h2 = jnp.minimum(h2, tmax)      # if hit2.t > tmax { hit2.t = tmax }
    valid = okv & (h1 < h2)
    h1 = jnp.maximum(h1, 0.0)       # if hit1.t < 0 { hit1.t = 0 }
    ray_len = jnp.sqrt(a)           # (R, 1)
    dist_inside = (h2 - h1) * ray_len
    # free flight: -1/rho * ln(U)
    hit_dist = spheres.neg_inv_density[None, ns:] * jnp.log(
        jnp.maximum(u_vol, 1e-37)
    )
    t_vol = h1 + hit_dist / ray_len
    t_vol = jnp.where(valid & (hit_dist <= dist_inside), t_vol, INF)

    return jnp.concatenate([t_solid[:, :ns], t_vol], axis=1)


def sphere_normal(spheres, prim, point):
    """Outward normal for sphere hits: (p - c)/r (lib/objects.rs:48), or the
    volume dummy normal (1,0,0) (lib/volume.rs:66-72)."""
    c = tgather(spheres.center, prim)
    r = tgather(spheres.radius, prim)
    outward = (point - c) / r[..., None]
    is_vol = tgather(spheres.neg_inv_density, prim) != 0.0
    dummy = jnp.array([1.0, 0.0, 0.0], outward.dtype)
    return jnp.where(is_vol[..., None], dummy, outward)


# ---------------------------------------------------------------- triangles

def triangle_constants(triangles):
    """Per-triangle constant vectors for the matmul formulation."""
    n = vec.cross(triangles.e1, triangles.e2)        # (T, 3) unnormalized
    v0xe2 = vec.cross(triangles.v0, triangles.e2)
    v0xe1 = vec.cross(triangles.v0, triangles.e1)
    v0n = vec.dot(triangles.v0, n)                   # (T,)
    return n, v0xe2, v0xe1, v0n


def triangle_ts_raw(triangles, o, d):
    """All-pairs Moller-Trumbore with NO t-range restriction ->
    (t (R, T), geo_valid (R, T)).  Volume boundary crossings need hits at
    ANY t — the ray origin may be inside the medium, making the entry
    crossing negative (lib/volume.rs: boundary.hit over (-inf, inf))."""
    n, v0xe2, v0xe1, v0n = triangle_constants(triangles)
    w = vec.cross(o, d)                               # (R, 3) ray moment

    a = -_dotT(d, n)                                  # (R, T)
    num_u = _dotT(w, triangles.e2) + _dotT(d, v0xe2)
    num_v = -(_dotT(w, triangles.e1) + _dotT(d, v0xe1))
    num_t = _dotT(o, n) - v0n[None, :]

    f = 1.0 / a
    u = f * num_u
    v = f * num_v
    t = f * num_t

    geo = (
        (jnp.abs(a) > TRI_DET_EPS)
        & (u >= 0.0) & (u <= 1.0)
        & (v >= 0.0) & (u + v <= 1.0)
    )
    return t, geo


def triangle_ts(triangles, o, d, tmin, tmax):
    """All-pairs Moller-Trumbore -> (R, T) hit distances, +inf for misses."""
    t, geo = triangle_ts_raw(triangles, o, d)
    valid = geo & (t > tmin) & (t <= tmax)
    return jnp.where(valid, t, INF)


def mesh_volume_ts(scene, o, d, u_mesh, tmin, tmax):
    """Free-flight hit distances for MESH-bounded constant-density volumes
    -> (R, V) with +inf for misses.

    Per volume: first/second boundary crossings among ITS triangles (the
    reference's two nested ``boundary.hit`` calls, lib/volume.rs:35-53,
    with a Mesh boundary), then the exponential free flight of the sphere
    path (sphere_ts) with this volume's own uniform column.
    """
    tris = scene.triangles
    t_raw, geo = triangle_ts_raw(tris, o, d)
    vol = tris.volume
    ray_len = jnp.sqrt(vec.length_squared(d))         # (R,)
    cols = []
    for v in range(scene.num_mesh_volumes):           # static small count
        m = geo & (vol[None, :] == v)
        tv = jnp.where(m, t_raw, INF)
        t1 = jnp.min(tv, axis=1)                      # entry (any t)
        # exit: next crossing strictly past the entry (re-hit offset tmin,
        # the sphere path's `t2 >= t1 + tmin` rule)
        t2 = jnp.min(jnp.where(tv >= t1[:, None] + tmin, tv, INF), axis=1)
        h1 = jnp.maximum(t1, tmin)
        h2 = jnp.minimum(t2, tmax)
        valid = jnp.isfinite(t1) & jnp.isfinite(t2) & (h1 < h2)
        h1 = jnp.maximum(h1, 0.0)
        dist_inside = (h2 - h1) * ray_len
        nid = scene.mesh_volumes.neg_inv_density[v]
        hit_dist = nid * jnp.log(jnp.maximum(u_mesh[:, v], 1e-37))
        t_v = h1 + hit_dist / ray_len
        cols.append(jnp.where(valid & (hit_dist <= dist_inside), t_v, INF))
    return jnp.stack(cols, axis=1)


# ------------------------------------------------- single-prim (gathered)

def gather_sphere_t(spheres, sidx, o, d, u_vol, tmin, tmax):
    """Per-ray single-sphere hit distance (ray i vs sphere sidx[i]) in the
    direct (o - c) form — the numerically canonical formula; the matmul
    expansion above is used only to FIND the winner."""
    c = tgather(spheres.center, sidx)
    r = tgather(spheres.radius, sidx)
    oc = o - c
    a = vec.length_squared(d)
    half_b = vec.dot(oc, d)
    cq = vec.length_squared(oc) - r * r
    disc = half_b * half_b - a * cq
    ok = disc >= 0.0
    sq = jnp.sqrt(jnp.where(ok, disc, 1.0))  # double-where, see sphere_ts
    sq = jnp.where(ok, sq, 0.0)
    t1 = (-half_b - sq) / a
    t2 = (-half_b + sq) / a

    in1 = (t1 >= tmin) & (t1 <= tmax)
    in2 = (t2 >= tmin) & (t2 <= tmax)
    t_solid = jnp.where(ok & in1, t1, jnp.where(ok & in2, t2, INF))

    nv = spheres.num_volumes
    if nv == 0:
        return t_solid

    # constant-density volume (lib/volume.rs:35-73); see sphere_ts
    ordinal = jnp.clip(sidx - spheres.num_solid, 0, nv - 1)
    uu = jnp.take_along_axis(u_vol, ordinal[:, None], axis=1)[:, 0]
    h1 = jnp.maximum(t1, tmin)
    h2 = jnp.where(t2 >= t1 + tmin, t2, INF)
    h2 = jnp.minimum(h2, tmax)
    valid = ok & (h1 < h2)
    h1 = jnp.maximum(h1, 0.0)
    ray_len = jnp.sqrt(a)
    dist_inside = (h2 - h1) * ray_len
    nid = tgather(spheres.neg_inv_density, sidx)
    hit_dist = nid * jnp.log(jnp.maximum(uu, 1e-37))
    t_vol = h1 + hit_dist / ray_len
    t_vol = jnp.where(valid & (hit_dist <= dist_inside), t_vol, INF)

    return jnp.where(nid != 0.0, t_vol, t_solid)


def gather_triangle_t(triangles, tidx, o, d, tmin, tmax):
    """Per-ray single-triangle Moller-Trumbore, classic cross-product form
    (one triangle per ray — nothing to matmul)."""
    v0 = tgather(triangles.v0, tidx)
    e1 = tgather(triangles.e1, tidx)
    e2 = tgather(triangles.e2, tidx)
    h = vec.cross(d, e2)
    a = vec.dot(e1, h)
    f = 1.0 / a
    s = o - v0
    u = f * vec.dot(s, h)
    q = vec.cross(s, e1)
    v = f * vec.dot(d, q)
    t = f * vec.dot(e2, q)
    valid = (
        (jnp.abs(a) > TRI_DET_EPS)
        & (u >= 0.0) & (u <= 1.0)
        & (v >= 0.0) & (u + v <= 1.0)
        & (t > tmin) & (t <= tmax)
    )
    return jnp.where(valid, t, INF)


def prim_t(scene, prim, o, d, u_vol, tmin, tmax):
    """Hit distance of each ray against ITS OWN candidate primitive id
    (clipped gathers keep out-of-range ids safe; callers mask)."""
    ns = len(scene.spheres)
    nt = len(scene.triangles)
    t = jnp.full(prim.shape, INF)
    if ns > 0:
        sidx = jnp.clip(prim, 0, ns - 1)
        t_s = gather_sphere_t(scene.spheres, sidx, o, d, u_vol, tmin, tmax)
        t = jnp.where(prim < ns, t_s, t)
    if nt > 0:
        tidx = jnp.clip(prim - ns, 0, nt - 1)
        t_t = gather_triangle_t(scene.triangles, tidx, o, d, tmin, tmax)
        t = jnp.where(prim >= ns, t_t, t)
    return t


# ------------------------------------------------------------------- merge

def make_hit(scene, o, d, t, best):
    """Assemble the winning Hit from per-ray (t, global prim id).

    Miss lanes get SAFE placeholder geometry (t=1, normal=+z) instead of
    inf/garbage: dead-lane values are masked out of the result anyway, but a
    non-finite primal in an unselected jnp.where branch still poisons
    reverse-mode AD (0 * nan = nan in the VJP) — the classic double-where
    hazard."""
    ns = len(scene.spheres)
    missed = ~jnp.isfinite(t)
    prim = jnp.where(missed, -1, best).astype(jnp.int32)
    safe_t = jnp.where(missed, 1.0, t)
    point = o + safe_t[..., None] * d

    sidx = jnp.clip(best, 0, max(ns - 1, 0))
    is_sphere = best < ns
    if ns > 0:
        outward = sphere_normal(scene.spheres, sidx, point)
        mat = tgather(scene.spheres.material, sidx)
    else:
        outward = jnp.zeros_like(o)
        mat = jnp.zeros(o.shape[:-1], jnp.int32)
    nt = len(scene.triangles)
    if nt > 0:
        tidx = jnp.clip(best - ns, 0, nt - 1)
        outward = jnp.where(
            is_sphere[..., None], outward, tgather(scene.triangles.normal, tidx)
        )
        mat = jnp.where(is_sphere, mat, tgather(scene.triangles.material, tidx))
    if scene.num_mesh_volumes:
        # mesh-volume winners: delegated material + the volume dummy
        # normal (1, 0, 0) (lib/volume.rs:66-72)
        is_mv = best >= ns + nt
        vidx = jnp.clip(best - ns - nt, 0, scene.num_mesh_volumes - 1)
        mat = jnp.where(is_mv,
                        tgather(scene.mesh_volumes.material, vidx), mat)
        dummy = jnp.zeros_like(outward).at[..., 0].set(1.0)
        outward = jnp.where(is_mv[..., None], dummy, outward)

    unit_z = jnp.zeros_like(outward).at[..., 2].set(1.0)
    outward = jnp.where(missed[..., None], unit_z, outward)

    # HitRecord::new front-face flip (lib/utils/ray.rs:39-54)
    front_face = vec.dot(d, outward) < 0.0
    normal = jnp.where(front_face[..., None], outward, -outward)
    t = jnp.where(missed, INF, t)
    return Hit(t=t, prim=prim, material=mat, point=point,
               normal=normal, front_face=front_face)


def intersect_brute(scene, o, d, u_vol, tmin=T_MIN, tmax=INF):
    """Brute-force closest hit over every primitive — the linear-scan path
    (lib/core/scene.rs:141-157) vectorized into matmuls.  For scenes up to a
    few hundred primitives this is the XLA engine's fast path; the BVH
    exists for the big ones.

    ``u_vol``: (R, num sphere volumes + num mesh volumes) free-flight
    uniforms, sphere-volume columns first.
    """
    n_sv = scene.spheres.num_volumes
    n_mv = scene.num_mesh_volumes
    parts = []
    if len(scene.spheres) > 0:
        parts.append(sphere_ts(scene.spheres, o, d, u_vol[:, :n_sv],
                               tmin, tmax))
    if len(scene.triangles) > 0:
        t_tri = triangle_ts(scene.triangles, o, d, tmin, tmax)
        if n_mv:
            # mesh-volume boundary triangles never shade as surfaces
            t_tri = jnp.where(scene.triangles.volume[None, :] >= 0,
                              INF, t_tri)
        parts.append(t_tri)
    if n_mv:
        parts.append(mesh_volume_ts(scene, o, d, u_vol[:, n_sv:],
                                    tmin, tmax))
    if not parts:
        r = o.shape[0]
        return Hit(
            t=jnp.full((r,), INF), prim=jnp.full((r,), -1, jnp.int32),
            material=jnp.zeros((r,), jnp.int32), point=o,
            normal=jnp.zeros_like(o),
            front_face=jnp.zeros((r,), bool),
        )
    # columns are [0, N) spheres, [N, N+T) triangles, then [N+T, N+T+V)
    # mesh volumes, so the argmin column index IS the global primitive id
    t_all = jnp.concatenate(parts, axis=1) if len(parts) > 1 else parts[0]
    t_min = jnp.min(t_all, axis=1)
    best = jnp.argmin(t_all, axis=1).astype(jnp.int32)
    missed = ~jnp.isfinite(t_min)
    # re-intersect the winner in the direct single-primitive form: canonical
    # f32 result (bitwise-identical to the BVH path) and the differentiable
    # t for reparameterized gradients.  Mesh-volume winners keep their
    # matmul-path t (already differentiable; there is no single-primitive
    # form for a whole boundary mesh).
    n_st = len(scene.spheres) + len(scene.triangles)
    t = prim_t(scene, jnp.clip(best, 0, max(n_st - 1, 0)), o, d,
               u_vol[:, :n_sv], tmin, INF)
    if n_mv:
        t = jnp.where(best >= n_st, t_min, t)
    t = jnp.where(missed, INF, t)
    return make_hit(scene, o, d, t, best)
