"""Sphere megakernel: a Pallas kernel on the Triton route.

The XLA integrator (render/integrator.py) keeps the whole wavefront in
device memory between bounces.  This kernel keeps each ray's state in
registers for its entire bounce chain instead:

  * a 1-D grid over blocks of ``block`` rays (a power of two); every
    program traces its rays independently, so blocks run in any order;
  * the sphere loop is UNROLLED over the scene.  Scene constants are one
    ordinary whole-array input (``fparams``) read by static scalar index;
  * counter-based threefry2x32 (cipher + counter layout shared with
    utils/rng.py): the kernel consumes the same uniform draws as the XLA
    integrator, so the two engines agree up to f32 arithmetic order.  The
    forward chain is a ``while_loop`` that exits once every ray of the
    block is dead;
  * material lobes compile only for kinds the scene uses; per-sphere
    material KINDS are static (geometry edits recompile) while all material
    VALUES (albedo/fuzz/ir/emission, camera, background) stay runtime
    inputs, so inverse-rendering steps never recompile.

Differentiable end to end.  The backward is a second kernel that replays
the chain UNROLLED (reverse mode cannot transpose a while_loop) and traces
``jax.vjp`` of the same :func:`_radiance_math` into its body, so forward
and backward share one source.  Each program writes one partial cotangent
row; XLA sums the rows after the call (no atomics: gradients are bitwise
reproducible run to run).  The fit step's MSE loss fuses into the grad
kernel (:func:`mse_loss_pallas`): one kernel pass per ``value_and_grad``.

Envelope (static :func:`supports`; every other scene runs on XLA): at
most MAX_UNROLLED_SPHERES spheres, solid or constant-density volumes, no
triangles, single-level mix materials, uniform / gradient / skymap
backgrounds (a skymap records each ray's escape; the texel lookup is one
XLA gather after the kernel, :func:`_env_finish`), Full and Clay modes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..models import backgrounds as B
from ..models import materials as M
from ..models.scene import MODE_CLAY, MODE_FULL, Scene
from ..utils.rng import CIPHER_BLOCK, bits_to_uniform, threefry2x32
from ..utils.types import T_MIN

# Rays per program and warps per program, by kernel, chosen on an H100 at
# 512x512, spp 8, depth 6 on the benchmark scene (PERF.md).  The forward
# is flat from 64 to 256 rays per program.  The grad kernels want one warp
# per program: their parameter cotangents are block sums, which one warp
# reduces with shuffles alone (32 rays x 1 warp ran 2.2x faster than
# 128 x 2, 2.7x faster than 64 x 2).
FWD_BLOCK, FWD_WARPS = 128, 4
GRAD_BLOCK, GRAD_WARPS = 32, 1

# float scalar-param layout
_CAM = 0            # origin(3) horizontal(3) vertical(3) lower_left(3)
_BG = 12            # color_a(3) color_b(3)
_INV_W = 18         # 1 / (width - 1)
_INV_H = 19         # 1 / (height - 1)
_SPHERES = 20       # per sphere: cx cy cz r  al_r al_g al_b  fuzz ir
_SPHERE_STRIDE = 12  # em_r em_g em_b
# Mix scenes extend the per-sphere record with the SECOND resolved leaf +
# the mix coin threshold: factor  al2(3) fuzz2 ir2 em2(3)  (stride 21).
# Leaf A rides the base slots (mix_first == self for non-mix rows, so the
# packing is uniform; models/materials.py build_table).  Volume scenes
# append one more slot: neg_inv_density (0.0 for solid spheres).
_SPHERE_STRIDE_MIX = 21


def _sphere_stride(mix: bool, vol: bool = False) -> int:
    return (_SPHERE_STRIDE_MIX if mix else _SPHERE_STRIDE) + int(vol)


MAX_UNROLLED_SPHERES = 128  # the ~100-sphere grid and simple.json class

# The grad kernels unroll the sphere loop inside an unrolled bounce chain,
# and their compile time grows faster than that product: on an H100, 5
# spheres x 6 bounces compiled in 37 s, 5 x 12 in 153 s, and 100 x 6 had
# not finished after 13 min.  Larger fits run on the XLA engine.
MAX_GRAD_UNROLL = 60  # spheres x bounces


def _mix_in_kernel_ok(scene: Scene) -> bool:
    """Mix materials the kernel can shade: SINGLE-LEVEL mixes only.

    A single-level mix resolves with ONE coin against two concrete leaves,
    which the kernel bakes as a second per-sphere parameter set (the
    reference's stochastic blend, lib/materials.rs:149-156).  Mix-of-mix
    scenes keep the XLA engine (resolve_mix's chain, ops/shade.py:47-67)."""
    mats = scene.materials
    if not mats.has_mix:
        return True
    kind = np.asarray(mats.kind)
    mix_rows = kind == M.MIX
    child_a = np.asarray(mats.mix_first)[mix_rows]
    child_b = np.asarray(mats.mix_second)[mix_rows]
    return (kind[child_a] != M.MIX).all() and (kind[child_b] != M.MIX).all()


def env_is_active(scene: Scene) -> bool:
    """True when the scene USES the one-sample-MIS environment importance
    sampler (render/integrator.py): the flag is set AND the background is
    an HDRI sky AND the mode shades materials.  The kernel implements only
    the naive escape-lookup estimator, so such scenes stay on XLA."""
    return (
        scene.settings.env_importance_sampling
        and scene.background.kind == B.SKYMAP
        and scene.settings.mode == MODE_FULL  # debug views never shade
    )


def supports(scene: Scene) -> bool:
    """Static capability check for the (differentiable) sphere kernel.

    Constant-density volumes are supported: the unrolled sphere loop
    indexes each volume's free-flight uniform column statically (volumes
    sort last in the sphere SoA).  SKYMAP backgrounds are supported and
    differentiable: the kernel RECORDS each ray's (miss direction,
    throughput) — a path misses at most once — and the driver adds
    ``throughput * sky(dir)`` with one batched XLA gather afterwards
    (:func:`_env_finish`).  The miss records ride the custom_vjp pair as
    primal outputs, so the gather's cotangents enter the grad kernel.
    """
    return (
        len(scene.triangles) == 0
        and 0 < len(scene.spheres) <= MAX_UNROLLED_SPHERES
        and _mix_in_kernel_ok(scene)
        and scene.num_mesh_volumes == 0
        and scene.background.kind in (B.UNIFORM, B.GRADIENT, B.SKYMAP)
        and not env_is_active(scene)
        and scene.settings.mode in (MODE_FULL, MODE_CLAY)
    )


def supports_grad(scene: Scene) -> bool:
    """The grad kernels' envelope: :func:`supports`, with at most
    MAX_GRAD_UNROLL spheres x bounces to unroll."""
    return (supports(scene)
            and len(scene.spheres) * scene.settings.max_ray_depth
            <= MAX_GRAD_UNROLL)


def supports_fused_mse(scene: Scene) -> bool:
    """Static gate for the fused render->MSE->grad kernel: the grad
    envelope minus skymap (the texel gather cannot run in-kernel), with
    each pixel's samples padded to a power-of-two group of at most 256
    contiguous rays."""
    return (
        supports_grad(scene)
        and scene.background.kind in (B.UNIFORM, B.GRADIENT)
        and scene.settings.samples_per_pixel <= 256
    )


# -------------------------------------------------------- counter-based RNG
#
# The cipher + counter layout live in utils/rng.py and are SHARED with the
# XLA integrator: uniform column c of stream s for ray r is word (c % 2) of
# threefry2x32(seed, x0=r, x1=s*CIPHER_BLOCK + c//2) in both engines, so the
# two consume byte-identical randomness (tests/test_pallas.py).

def _stream_uniforms(k0, k1, ray_id_u32, stream, n: int):
    """First n uniform columns of (ray, stream) — ceil(n/2) ciphers.
    ``stream`` may be a traced scalar (the while-loop bounce index)."""
    base = jnp.broadcast_to(
        jnp.asarray(stream, jnp.uint32) * np.uint32(CIPHER_BLOCK),
        ray_id_u32.shape,
    )
    cols = []
    for j in range(-(-n // 2)):
        a0, a1 = threefry2x32(k0, k1, ray_id_u32, base + np.uint32(j))
        cols.append(bits_to_uniform(a0))
        cols.append(bits_to_uniform(a1))
    return cols[:n]


def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _radiance_math(f, k0, k1, ray_u32, px, py, *, n_spheres, max_depth,
                   sphere_kinds, bg_kind, clay, unrolled, mix=False,
                   n_vol=0):
    """The kernel's radiance computation as a PURE function of one ray
    block.

    ``f(i)`` is a scalar getter over the packed float-param layout (a load
    from the ``fparams`` input in the forward kernel; the vjp inputs in the
    grad kernels, so ``jax.vjp`` of this very function yields the
    parameter cotangents).  ``unrolled`` replaces the early-out
    while_loop with a static chain — required under vjp.  ``mix``: the
    scene table has (single-level) mix materials — per-bounce uniform
    columns shift by MAX_MIX_DEPTH to stay stream-aligned with the XLA
    engine (ops/shade.py:shade_uniforms) and every sphere carries two baked
    leaf-parameter sets blended by the level-0 mix coin.  ``n_vol``: the
    last ``n_vol`` spheres are constant-density volumes.

    Returns (rad_r, rad_g, rad_b); with ``bg_kind == SKYMAP`` additionally
    (mdx, mdy, mdz, mt_r, mt_g, mt_b) — the MISS direction and throughput
    recorded when each path escaped (zeros if it never did), for the
    driver's batched equirect lookup outside the kernel.
    """
    skymap = bg_kind == B.SKYMAP
    present = _flat_kinds(sphere_kinds)
    lam = M.LAMBERTIAN in present
    met = M.METAL in present
    die = M.DIELECTRIC in present
    emi = M.EMISSION in present
    iso = M.ISOTROPIC in present
    stride = _sphere_stride(mix, n_vol > 0)
    n_solid = n_spheres - n_vol

    ox_c, oy_c, oz_c = f(_CAM + 0), f(_CAM + 1), f(_CAM + 2)
    hx, hy, hz = f(_CAM + 3), f(_CAM + 4), f(_CAM + 5)
    vx, vy, vz = f(_CAM + 6), f(_CAM + 7), f(_CAM + 8)
    llx, lly, llz = f(_CAM + 9), f(_CAM + 10), f(_CAM + 11)

    # pixel jitter (stream 0) -> camera ray (lib/core/camera.rs:19-24)
    j1, j2 = _stream_uniforms(k0, k1, ray_u32, 0, 2)
    s = (px + j1) * f(_INV_W)
    t = (py + j2) * f(_INV_H)
    dx = llx + s * hx - t * vx - ox_c
    dy = lly + s * hy - t * vy - oy_c
    dz = llz + s * hz - t * vz - oz_c
    ox = jnp.zeros_like(dx) + ox_c
    oy = jnp.zeros_like(dx) + oy_c
    oz = jnp.zeros_like(dx) + oz_c

    one = jnp.ones_like(dx)
    zero = jnp.zeros_like(dx)

    def background(dx, dy, dz):
        ca = (f(_BG + 0), f(_BG + 1), f(_BG + 2))
        if bg_kind == B.UNIFORM:
            return tuple(zero + c for c in ca)
        cb = (f(_BG + 3), f(_BG + 4), f(_BG + 5))
        norm = jax.lax.rsqrt(_dot3(dx, dy, dz, dx, dy, dz))
        tt = 0.5 * (dy * norm + 1.0)
        return tuple((1.0 - tt) * a + tt * b for a, b in zip(ca, cb))

    def shade(b, a, hit, ptx, pty, ptz, nx, ny, nz,
              al_r, al_g, al_b, fuzz, ir, em_r, em_g, em_b,
              is_lam, is_met, is_die, is_emi, is_iso,
              alive, u1, u2, u_coin, u_r,
              ox, oy, oz, dx, dy, dz,
              thr_r, thr_g, thr_b, rad_r, rad_g, rad_b, miss):
        """Bounce tail: background on miss, front-face flip, material
        lobes, throughput/radiance update -> next state.  ``miss``: () or
        the 6 skymap miss-record registers."""
        missed = alive & ~hit
        if skymap:
            # record the escape (a path misses at most once); the
            # equirect texel fetch happens OUTSIDE the kernel
            mdx, mdy, mdz, mt_r, mt_g, mt_b = miss
            miss = (jnp.where(missed, dx, mdx),
                    jnp.where(missed, dy, mdy),
                    jnp.where(missed, dz, mdz),
                    jnp.where(missed, thr_r, mt_r),
                    jnp.where(missed, thr_g, mt_g),
                    jnp.where(missed, thr_b, mt_b))
        else:
            # background on miss (lib/core/render.rs:57)
            bg_r, bg_g, bg_b = background(dx, dy, dz)
            rad_r = rad_r + jnp.where(missed, thr_r * bg_r, 0.0)
            rad_g = rad_g + jnp.where(missed, thr_g * bg_g, 0.0)
            rad_b = rad_b + jnp.where(missed, thr_b * bg_b, 0.0)

        front = _dot3(dx, dy, dz, nx, ny, nz) < 0.0
        sgn = jnp.where(front, 1.0, -1.0)
        nx, ny, nz = nx * sgn, ny * sgn, nz * sgn

        # unit-sphere-surface sample from (u1, u2)
        zs = 1.0 - 2.0 * u1
        rs = jnp.sqrt(jnp.maximum(0.0, 1.0 - zs * zs))
        phi = (2.0 * np.float32(np.pi)) * u2
        sx = rs * jnp.cos(phi)
        sy = rs * jnp.sin(phi)
        sz = zs

        def lambert_dir():
            ldx, ldy, ldz = nx + sx, ny + sy, nz + sz
            deg = (
                (jnp.abs(ldx) < 1e-8)
                & (jnp.abs(ldy) < 1e-8)
                & (jnp.abs(ldz) < 1e-8)
            )
            return (
                jnp.where(deg, nx, ldx),
                jnp.where(deg, ny, ldy),
                jnp.where(deg, nz, ldz),
            )

        scatters = zero < one
        if clay:
            at_r = at_g = at_b = zero + 0.8
            ndx, ndy, ndz = lambert_dir()
        else:
            at_r, at_g, at_b = zero, zero, zero
            ndx, ndy, ndz = nx, ny, nz

            if lam:
                ldx, ldy, ldz = lambert_dir()
                at_r = jnp.where(is_lam, al_r, at_r)
                at_g = jnp.where(is_lam, al_g, at_g)
                at_b = jnp.where(is_lam, al_b, at_b)
                ndx = jnp.where(is_lam, ldx, ndx)
                ndy = jnp.where(is_lam, ldy, ndy)
                ndz = jnp.where(is_lam, ldz, ndz)

            if met:
                dn = _dot3(dx, dy, dz, nx, ny, nz)
                rfx = dx - 2.0 * dn * nx
                rfy = dy - 2.0 * dn * ny
                rfz = dz - 2.0 * dn * nz
                inv_len = jax.lax.rsqrt(jnp.maximum(
                    _dot3(rfx, rfy, rfz, rfx, rfy, rfz), 1e-30
                ))
                mdx = rfx * inv_len + fuzz * sx
                mdy = rfy * inv_len + fuzz * sy
                mdz = rfz * inv_len + fuzz * sz
                m_ok = _dot3(mdx, mdy, mdz, nx, ny, nz) > 0.0
                at_r = jnp.where(is_met, jnp.where(m_ok, al_r, 0.0), at_r)
                at_g = jnp.where(is_met, jnp.where(m_ok, al_g, 0.0), at_g)
                at_b = jnp.where(is_met, jnp.where(m_ok, al_b, 0.0), at_b)
                ndx = jnp.where(is_met, mdx, ndx)
                ndy = jnp.where(is_met, mdy, ndy)
                ndz = jnp.where(is_met, mdz, ndz)
                scatters = (is_met & m_ok) | (~is_met & scatters)

            if die:
                ratio = jnp.where(front, 1.0 / ir, ir)
                inv_len = jax.lax.rsqrt(jnp.maximum(a, 1e-30))
                udx, udy, udz = dx * inv_len, dy * inv_len, dz * inv_len
                cos_t = jnp.minimum(-_dot3(nx, ny, nz, udx, udy, udz), 1.0)
                sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
                r0 = (1.0 - ratio) / (1.0 + ratio)
                r0 = r0 * r0
                omc = 1.0 - cos_t
                omc2 = omc * omc
                schl = r0 + (1.0 - r0) * omc2 * omc2 * omc
                refl = (ratio * sin_t > 1.0) | (schl > u_coin)
                udn = _dot3(udx, udy, udz, nx, ny, nz)
                rx = udx - 2.0 * udn * nx
                ry = udy - 2.0 * udn * ny
                rz = udz - 2.0 * udn * nz
                perp_x = ratio * (udx + cos_t * nx)
                perp_y = ratio * (udy + cos_t * ny)
                perp_z = ratio * (udz + cos_t * nz)
                par = -jnp.sqrt(jnp.maximum(jnp.abs(
                    1.0 - _dot3(perp_x, perp_y, perp_z,
                                perp_x, perp_y, perp_z)
                ), 1e-12))
                at_r = jnp.where(is_die, 1.0, at_r)
                at_g = jnp.where(is_die, 1.0, at_g)
                at_b = jnp.where(is_die, 1.0, at_b)
                ndx = jnp.where(is_die, jnp.where(refl, rx, perp_x + par * nx),
                                ndx)
                ndy = jnp.where(is_die, jnp.where(refl, ry, perp_y + par * ny),
                                ndy)
                ndz = jnp.where(is_die, jnp.where(refl, rz, perp_z + par * nz),
                                ndz)

            if emi:
                at_r = jnp.where(is_emi, em_r, at_r)
                at_g = jnp.where(is_emi, em_g, at_g)
                at_b = jnp.where(is_emi, em_b, at_b)
                scatters = scatters & ~is_emi

            if iso:
                # Isotropic phase function (lib/volume.rs:75-88): new dir =
                # unit-sphere-VOLUME sample — the surface sample scaled by
                # cbrt01(u), the exp/log form shared with ops/shade.py
                crt = jnp.exp(jnp.log(jnp.maximum(u_r, 1e-38))
                              * (1.0 / 3.0))
                at_r = jnp.where(is_iso, al_r, at_r)
                at_g = jnp.where(is_iso, al_g, at_g)
                at_b = jnp.where(is_iso, al_b, at_b)
                ndx = jnp.where(is_iso, sx * crt, ndx)
                ndy = jnp.where(is_iso, sy * crt, ndy)
                ndz = jnp.where(is_iso, sz * crt, ndz)

        terminal = alive & hit & ~scatters
        rad_r = rad_r + jnp.where(terminal, thr_r * at_r, 0.0)
        rad_g = rad_g + jnp.where(terminal, thr_g * at_g, 0.0)
        rad_b = rad_b + jnp.where(terminal, thr_b * at_b, 0.0)

        cont = alive & hit & scatters
        thr_r = jnp.where(cont, thr_r * at_r, thr_r)
        thr_g = jnp.where(cont, thr_g * at_g, thr_g)
        thr_b = jnp.where(cont, thr_b * at_b, thr_b)
        ox = jnp.where(cont, ptx, ox)
        oy = jnp.where(cont, pty, oy)
        oz = jnp.where(cont, ptz, oz)
        dx = jnp.where(cont, ndx, dx)
        dy = jnp.where(cont, ndy, dy)
        dz = jnp.where(cont, ndz, dz)
        alive_f = jnp.where(cont, 1.0, 0.0)
        return (b + 1, ox, oy, oz, dx, dy, dz,
                thr_r, thr_g, thr_b, rad_r, rad_g, rad_b,
                *miss, alive_f)

    # The liveness mask rides the loop carry as f32.
    def bounce_body(state):
        (b, ox, oy, oz, dx, dy, dz,
         thr_r, thr_g, thr_b, rad_r, rad_g, rad_b,
         *miss, alive_f) = state
        miss = tuple(miss)
        alive = alive_f > 0.0
        # per-bounce uniforms (stream 1 + b).  Column layout matches the
        # XLA engine bit-for-bit (ops/shade.py shade_uniforms): [mix coins
        # x MAX_MIX_DEPTH if has_mix] ++ [dir1 dir2 coin radius].  Only the
        # level-0 mix coin is consumed (XLA's levels 1-3 are no-ops on
        # single-level mixes), and radius only when an Isotropic exists.
        # Volume scenes draw one extra column per volume object (the
        # free-flight uniform; XLA: u_vol = u[:, n_shade:]).
        off = M.MAX_MIX_DEPTH if mix else 0
        n_u = off + ((4 if iso else 3) if n_vol == 0 else 4 + n_vol)
        us = _stream_uniforms(k0, k1, ray_u32, 1 + b, n_u)
        u_mix = us[0] if mix else None
        u1, u2, u_coin = us[off], us[off + 1], us[off + 2]
        u_r = us[off + 3] if iso else zero

        a = _dot3(dx, dy, dz, dx, dy, dz)
        inv_a = 1.0 / a

        # ---- intersect: unrolled sphere loop, direct quadratic form
        t_best = jnp.full_like(dx, jnp.inf)
        best = jnp.full(dx.shape, -1, jnp.int32)
        if n_vol:
            ray_len = jnp.sqrt(a)
        for i in range(n_spheres):
            base = _SPHERES + i * stride
            cx, cy, cz = f(base), f(base + 1), f(base + 2)
            r = f(base + 3)
            ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
            half_b = _dot3(ocx, ocy, ocz, dx, dy, dz)
            cq = _dot3(ocx, ocy, ocz, ocx, ocy, ocz) - r * r
            disc = half_b * half_b - a * cq
            ok = disc >= 0.0
            sq = jnp.sqrt(jnp.maximum(disc, 0.0))
            t1 = (-half_b - sq) * inv_a
            t2 = (-half_b + sq) * inv_a
            if i >= n_solid:
                # constant-density volume (lib/volume.rs:35-73), the exact
                # op order of ops/intersect.py sphere_ts: clamp the
                # boundary window, exponential free flight with THIS
                # volume's statically-indexed uniform column
                u_v = us[off + 4 + (i - n_solid)]
                nid = f(base + stride - 1)
                h1 = jnp.maximum(t1, T_MIN)
                h2 = jnp.where(t2 >= t1 + T_MIN, t2, jnp.inf)
                valid = ok & (h1 < h2)
                h1 = jnp.maximum(h1, 0.0)
                dist_inside = (h2 - h1) * ray_len
                hit_dist = nid * jnp.log(jnp.maximum(u_v, 1e-37))
                ti = h1 + hit_dist / ray_len
                ti = jnp.where(valid & (hit_dist <= dist_inside),
                               ti, jnp.inf)
                better = ti < t_best
            else:
                t1ok = (t1 >= T_MIN) & (t1 <= t_best)
                t2ok = (t2 >= T_MIN) & (t2 <= t_best)
                ti = jnp.where(t1ok, t1, jnp.where(t2ok, t2, jnp.inf))
                better = ok & (ti < t_best)
            t_best = jnp.where(better, ti, t_best)
            best = jnp.where(better, i, best)
        hit = best >= 0

        # ---- winner constants via unrolled select chains (no gathers)
        scx = scy = scz = inv_r = zero
        al_r = al_g = al_b = fuzz = ir = em_r = em_g = em_b = zero
        false_ = one < zero
        is_lam = is_met = is_die = is_emi = is_iso = false_
        vol_sel = false_
        if mix:
            # leaf-B parameter set + mix factor (blended below with the
            # level-0 coin)
            fac = zero
            al2_r = al2_g = al2_b = fuzz2 = ir2 = zero
            em2_r = em2_g = em2_b = zero
            is_lam2 = is_met2 = is_die2 = is_emi2 = is_iso2 = false_
        for i in range(n_spheres):
            base = _SPHERES + i * stride
            sel = best == i

            def pick(cur, v, sel=sel):
                return jnp.where(sel, v, cur)

            scx = pick(scx, f(base + 0))
            scy = pick(scy, f(base + 1))
            scz = pick(scz, f(base + 2))
            inv_r = pick(inv_r, 1.0 / f(base + 3))
            al_r = pick(al_r, f(base + 4))
            al_g = pick(al_g, f(base + 5))
            al_b = pick(al_b, f(base + 6))
            fuzz = pick(fuzz, f(base + 7))
            ir = pick(ir, f(base + 8))
            em_r = pick(em_r, f(base + 9))
            em_g = pick(em_g, f(base + 10))
            em_b = pick(em_b, f(base + 11))
            if i >= n_solid:
                vol_sel = vol_sel | sel
            k = sphere_kinds[i]  # static: int | (kind_a, kind_b)
            k_a, k_b = k if isinstance(k, tuple) else (k, k)
            if k_a == M.LAMBERTIAN:
                is_lam = is_lam | sel
            elif k_a == M.METAL:
                is_met = is_met | sel
            elif k_a == M.DIELECTRIC:
                is_die = is_die | sel
            elif k_a == M.EMISSION:
                is_emi = is_emi | sel
            elif k_a == M.ISOTROPIC:
                is_iso = is_iso | sel
            if mix:
                fac = pick(fac, f(base + 12))
                al2_r = pick(al2_r, f(base + 13))
                al2_g = pick(al2_g, f(base + 14))
                al2_b = pick(al2_b, f(base + 15))
                fuzz2 = pick(fuzz2, f(base + 16))
                ir2 = pick(ir2, f(base + 17))
                em2_r = pick(em2_r, f(base + 18))
                em2_g = pick(em2_g, f(base + 19))
                em2_b = pick(em2_b, f(base + 20))
                if k_b == M.LAMBERTIAN:
                    is_lam2 = is_lam2 | sel
                elif k_b == M.METAL:
                    is_met2 = is_met2 | sel
                elif k_b == M.DIELECTRIC:
                    is_die2 = is_die2 | sel
                elif k_b == M.EMISSION:
                    is_emi2 = is_emi2 | sel
                elif k_b == M.ISOTROPIC:
                    is_iso2 = is_iso2 | sel

        # hit point + outward normal (safe t on miss lanes: an inf primal
        # in a masked branch still poisons the vjp)
        safe_t = jnp.where(hit, t_best, 1.0)
        ptx = ox + safe_t * dx
        pty = oy + safe_t * dy
        ptz = oz + safe_t * dz
        nx = (ptx - scx) * inv_r
        ny = (pty - scy) * inv_r
        nz = (ptz - scz) * inv_r
        if n_vol:
            # volume dummy normal (1,0,0) (lib/volume.rs:66-72;
            # ops/intersect.py sphere_normal)
            nx = jnp.where(vol_sel, 1.0, nx)
            ny = jnp.where(vol_sel, 0.0, ny)
            nz = jnp.where(vol_sel, 0.0, nz)

        if mix:
            # level-0 mix coin: u >= factor picks the FIRST leaf
            # (lib/materials.rs:151; ops/shade.py resolve_mix).  Non-mix
            # spheres bake leaf A == leaf B and factor == 0, making the
            # blend the identity for them.
            pick_a = u_mix >= fac
            al_r = jnp.where(pick_a, al_r, al2_r)
            al_g = jnp.where(pick_a, al_g, al2_g)
            al_b = jnp.where(pick_a, al_b, al2_b)
            fuzz = jnp.where(pick_a, fuzz, fuzz2)
            ir = jnp.where(pick_a, ir, ir2)
            em_r = jnp.where(pick_a, em_r, em2_r)
            em_g = jnp.where(pick_a, em_g, em2_g)
            em_b = jnp.where(pick_a, em_b, em2_b)
            is_lam = (pick_a & is_lam) | (~pick_a & is_lam2)
            is_met = (pick_a & is_met) | (~pick_a & is_met2)
            is_die = (pick_a & is_die) | (~pick_a & is_die2)
            is_emi = (pick_a & is_emi) | (~pick_a & is_emi2)
            is_iso = (pick_a & is_iso) | (~pick_a & is_iso2)

        return shade(b, a, hit, ptx, pty, ptz, nx, ny, nz,
                     al_r, al_g, al_b, fuzz, ir, em_r, em_g, em_b,
                     is_lam, is_met, is_die, is_emi, is_iso,
                     alive, u1, u2, u_coin, u_r,
                     ox, oy, oz, dx, dy, dz,
                     thr_r, thr_g, thr_b, rad_r, rad_g, rad_b, miss)

    def bounce_cond(state):
        b, *_, alive_f = state
        return (b < max_depth) & (jnp.max(alive_f) > 0.0)

    miss0 = (zero,) * 6 if skymap else ()
    state = (jnp.int32(0), ox, oy, oz, dx, dy, dz,
             one, one, one, zero, zero, zero, *miss0, one)
    if unrolled:
        for _ in range(max_depth):
            state = bounce_body(state)
    else:
        # early-out: a block whose rays all escaped or terminated stops
        state = jax.lax.while_loop(bounce_cond, bounce_body, state)
    if skymap:
        return tuple(state[10:19])
    return state[10], state[11], state[12]


# ------------------------------------------------------------------ kernels

def _block_keys(iparams_ref, ray_ref):
    """Seed words + ray ids of one block -> (k0, k1, ray_u32)."""
    ray_u32 = ray_ref[...].astype(jnp.uint32)
    k0 = jnp.zeros_like(ray_u32) + iparams_ref[0].astype(jnp.uint32)
    k1 = jnp.zeros_like(ray_u32) + iparams_ref[1].astype(jnp.uint32)
    return k0, k1, ray_u32


def _store_row(ref, vals):
    """Write scalars into the program's (1, k_pad) output row."""
    for j, v in enumerate(vals):
        ref[0, j] = v


def _make_kernel(cfg):
    """Forward kernel: early-out while_loop chain, one output per radiance
    (or miss-record) register."""

    def kernel(iparams_ref, fp_ref, ray_ref, px_ref, py_ref, *outs):
        k0, k1, ray_u32 = _block_keys(iparams_ref, ray_ref)
        vals = _radiance_math(lambda i: fp_ref[i], k0, k1, ray_u32,
                              px_ref[...], py_ref[...], unrolled=False,
                              **cfg)
        for ref, val in zip(outs, vals):
            ref[...] = val

    return kernel


def _make_grad_kernel(cfg, k):
    """Forward-replay + backward kernel.

    ``jax.vjp`` over :func:`_radiance_math` traces reverse-mode AD INTO the
    kernel: the unrolled chain's residuals stay on chip for the whole
    forward and backward of a ray block.  The scene constants enter as k
    scalars; their cotangents are block sums, written as this program's
    partial row (summed across programs by XLA after the call)."""

    def kernel(iparams_ref, fp_ref, ray_ref, px_ref, py_ref, *refs):
        *ct_refs, dfp_ref = refs
        k0, k1, ray_u32 = _block_keys(iparams_ref, ray_ref)
        px, py = px_ref[...], py_ref[...]
        cts = tuple(r[...] for r in ct_refs)

        def block_radiance(*scalars):
            return _radiance_math(scalars.__getitem__, k0, k1, ray_u32,
                                  px, py, unrolled=True, **cfg)

        _, vjp_fn = jax.vjp(block_radiance, *(fp_ref[i] for i in range(k)))
        _store_row(dfp_ref, vjp_fn(cts))

    return kernel


def _make_mse_kernel(cfg, k, spp, spp_pad, clamp):
    """Fused loss+grad kernel.  Extra inputs per block: the block's
    block/spp_pad pixels' target rgb and weight (1/(3*H*W) for real
    pixels, 0 for padding — the exact jnp.mean((img-target)**2)
    normalization).  Outputs: this program's partial loss and partial
    parameter cotangents.

    Pixel means: ray order is pixel*spp_pad + sample, so one pixel's
    samples are CONTIGUOUS rays of the block.  They are averaged with a
    reshape to (pixels, spp_pad) and a masked sum — no matmul, so no
    reduced-precision dot can creep in.  Lanes [spp, spp_pad) of each group
    trace throwaway rays the mask ignores."""

    def kernel(iparams_ref, fp_ref, ray_ref, px_ref, py_ref,
               tr_ref, tg_ref, tb_ref, wt_ref, loss_ref, dfp_ref):
        k0, k1, ray_u32 = _block_keys(iparams_ref, ray_ref)
        px, py = px_ref[...], py_ref[...]
        tgt = (tr_ref[...], tg_ref[...], tb_ref[...])
        wt = wt_ref[...]
        n_pix = wt.shape[0]
        real = (jax.lax.broadcasted_iota(jnp.int32, (n_pix, spp_pad), 1)
                < spp)

        def block_loss(*scalars):
            vals = _radiance_math(scalars.__getitem__, k0, k1, ray_u32,
                                  px, py, unrolled=True, **cfg)
            loss = jnp.float32(0.0)
            for rad, t in zip(vals, tgt):
                c = jnp.clip(rad, 0.0, clamp).reshape(n_pix, spp_pad)
                m = jnp.sum(jnp.where(real, c, 0.0), axis=1) * (1.0 / spp)
                d = m - t
                loss = loss + jnp.sum(wt * d * d)
            return loss

        loss, vjp_fn = jax.vjp(block_loss, *(fp_ref[i] for i in range(k)))
        loss_ref[0] = loss
        _store_row(dfp_ref, vjp_fn(jnp.float32(1.0)))

    return kernel


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


class _Call:
    """Shared plumbing of one static kernel configuration: the padded
    parameter width, block specs and the pallas_call wrapper."""

    def __init__(self, cfg, n_pad, interpret, block, num_warps):
        self.cfg = dict(cfg)
        self.n_pad = n_pad
        self.grid = n_pad // block
        self.interpret = interpret
        self.params = plt.CompilerParams(num_warps=num_warps, num_stages=1)
        self.k = int(_SPHERES + cfg["n_spheres"]
                     * _sphere_stride(cfg["mix"], cfg["n_vol"] > 0))
        self.k_pad = _pow2(self.k)
        self.rays = pl.BlockSpec((block,), lambda i: (i,))
        self.row = pl.BlockSpec((1, self.k_pad), lambda i: (i, 0))
        self.head = [pl.BlockSpec((2,), lambda i: (0,)),
                     pl.BlockSpec((self.k_pad,), lambda i: (0,)),
                     self.rays, self.rays, self.rays]

    def pad(self, fparams):
        padded = jnp.zeros((self.k_pad,), jnp.float32).at[:self.k].set(
            fparams)
        if self.interpret:
            # The interpreter runs the kernel body as XLA code, which could
            # fuse the scene-constant arithmetic into it and round it
            # differently in each surrounding program; materialize it.
            padded = jax.lax.optimization_barrier(padded)
        return padded

    def __call__(self, kernel, name, in_specs, out_specs, out_shape, *args):
        return pl.pallas_call(
            kernel, out_shape=out_shape, grid=(self.grid,),
            in_specs=in_specs, out_specs=out_specs,
            backend="triton", compiler_params=self.params,
            interpret=self.interpret, name=name,
        )(*args)

    def forward(self, iparams, fparams, ray_ids, px, py):
        n_out = 9 if self.cfg["bg_kind"] == B.SKYMAP else 3
        out = jax.ShapeDtypeStruct((self.n_pad,), jnp.float32)
        return tuple(self(
            _make_kernel(self.cfg), "rtrt_sphere_fwd", self.head,
            [self.rays] * n_out, [out] * n_out,
            iparams, self.pad(fparams), ray_ids, px, py))

    def partials(self, rows):
        """(grid, k_pad) partial rows -> (k,) cotangent, summed by XLA in
        a fixed order."""
        return jnp.sum(rows[:, :self.k], axis=0)


@functools.lru_cache(maxsize=64)
def _radiance_cvjp(cfg, n_pad, interpret, block, num_warps,
                   grad_block, grad_warps):
    """custom_vjp-wrapped block radiance for one static configuration
    (``cfg``: a sorted tuple of _radiance_math keyword arguments).

    Primal: the early-out forward kernel.  Backward: the forward-replay +
    vjp kernel (_make_grad_kernel).  Cached per static config so jit
    re-traces reuse the same custom_vjp instance.  SKYMAP configs return
    NINE arrays (radiance rgb + miss direction + miss throughput); their
    cotangents all enter the grad kernel."""
    cfg = dict(cfg)
    fwd = _Call(cfg, n_pad, interpret, block, num_warps)
    bwd = _Call(cfg, n_pad, interpret, grad_block, grad_warps)
    n_out = 9 if cfg["bg_kind"] == B.SKYMAP else 3

    def run_grad(iparams, fparams, ray_ids, px, py, cts):
        rows = bwd(
            _make_grad_kernel(bwd.cfg, bwd.k), "rtrt_sphere_grad",
            bwd.head + [bwd.rays] * n_out, bwd.row,
            jax.ShapeDtypeStruct((bwd.grid, bwd.k_pad), jnp.float32),
            iparams, bwd.pad(fparams), ray_ids, px, py, *cts)
        return bwd.partials(rows)

    @jax.custom_vjp
    def radiance(fparams, iparams, ray_ids, px, py):
        return fwd.forward(iparams, fparams, ray_ids, px, py)

    def radiance_fwd(fparams, iparams, ray_ids, px, py):
        primal = fwd.forward(iparams, fparams, ray_ids, px, py)
        return primal, (fparams, iparams, ray_ids, px, py)

    def radiance_bwd(res, cts):
        fparams, iparams, ray_ids, px, py = res
        f0 = jax.dtypes.float0
        return (run_grad(iparams, fparams, ray_ids, px, py, tuple(cts)),
                np.zeros(iparams.shape, f0), np.zeros(ray_ids.shape, f0),
                jnp.zeros_like(px), jnp.zeros_like(py))

    radiance.defvjp(radiance_fwd, radiance_bwd)
    return radiance


@functools.lru_cache(maxsize=64)
def _mse_cvjp(cfg, n_pad, interpret, spp, spp_pad, clamp, block, num_warps,
              grad_block, grad_warps):
    """custom_vjp MSE loss for one static configuration.

    fwd rule = the FUSED loss+grad kernel (one pass computes the loss AND
    every parameter cotangent; the grads ARE the residuals); bwd = scale by
    the incoming scalar cotangent.  Plain (no-grad) calls run the forward
    kernel + an XLA reduction of the same formula."""
    cfg = dict(cfg)
    fwd = _Call(cfg, n_pad, interpret, block, num_warps)
    mse = _Call(cfg, n_pad, interpret, grad_block, grad_warps)
    pix = pl.BlockSpec((grad_block // spp_pad,), lambda i: (i,))

    def xla_loss(outs, tgt, wt):
        """The kernel's loss formula in XLA, for no-grad evaluations."""
        loss = jnp.float32(0.0)
        for rad, t in zip(outs, tgt):
            c = jnp.clip(rad, 0.0, clamp).reshape(-1, spp_pad)
            m = c[:, :spp].mean(axis=-1)
            loss = loss + jnp.sum(wt * (m - t) ** 2)
        return loss

    @jax.custom_vjp
    def loss_fn(fparams, tgt, wt, iparams, ray_ids, px, py):
        outs = fwd.forward(iparams, fparams, ray_ids, px, py)
        return xla_loss(outs, tgt, wt)

    def loss_fwd(fparams, tgt, wt, iparams, ray_ids, px, py):
        losses, rows = mse(
            _make_mse_kernel(mse.cfg, mse.k, spp, spp_pad, clamp),
            "rtrt_sphere_mse", mse.head + [pix] * 4,
            [pl.BlockSpec((1,), lambda i: (i,)), mse.row],
            [jax.ShapeDtypeStruct((mse.grid,), jnp.float32),
             jax.ShapeDtypeStruct((mse.grid, mse.k_pad), jnp.float32)],
            iparams, mse.pad(fparams), ray_ids, px, py, *tgt, wt)
        return jnp.sum(losses), mse.partials(rows)

    def loss_bwd(dfp, gbar):
        # target/weight are constants of the fit (mse_loss_pallas)
        f0 = jax.dtypes.float0
        n_pix = n_pad // spp_pad
        zeros = jnp.zeros((n_pix,), jnp.float32)
        return (dfp * gbar, (zeros,) * 3, zeros,
                np.zeros((2,), f0), np.zeros((n_pad,), f0),
                jnp.zeros((n_pad,), jnp.float32),
                jnp.zeros((n_pad,), jnp.float32))

    loss_fn.defvjp(loss_fwd, loss_bwd)
    return loss_fn


# ------------------------------------------------------------------ drivers

def _static_cfg(scene: Scene, sphere_kinds):
    """Hashable static kernel configuration of a (concrete) scene."""
    return tuple(sorted(dict(
        n_spheres=len(scene.spheres),
        max_depth=scene.settings.max_ray_depth,
        sphere_kinds=sphere_kinds,
        bg_kind=scene.background.kind,
        clay=scene.settings.mode == MODE_CLAY,
        mix=bool(scene.materials.has_mix),
        n_vol=scene.spheres.num_volumes,
    ).items()))


def _env_finish(scene: Scene, outs, n_rays: int):
    """Combine kernel outputs with the batched equirect lookup ->
    (n_rays, 3) radiance.  ``outs`` = 9 arrays: rgb radiance + miss
    direction + miss throughput."""
    (rad_r, rad_g, rad_b, mdx, mdy, mdz,
     mt_r, mt_g, mt_b) = (o[:n_rays] for o in outs)
    rad = jnp.stack([rad_r, rad_g, rad_b], axis=-1)
    d = jnp.stack([mdx, mdy, mdz], axis=-1)
    thr = jnp.stack([mt_r, mt_g, mt_b], axis=-1)
    # rays that never escaped keep the zero init; a real direction is never
    # the zero vector
    escaped = jnp.any(d != 0.0, axis=-1)
    safe_d = jnp.where(escaped[:, None], d,
                       jnp.array([0.0, 1.0, 0.0], jnp.float32))
    env = scene.background.sample(safe_d) * thr
    return rad + jnp.where(escaped[:, None], env, 0.0)


def _pack_fparams(scene: Scene, width: int, height: int, mix: bool = False):
    """Runtime scene constants -> (K,) f32 (traced; no host sync).

    ``mix`` extends each sphere record to _SPHERE_STRIDE_MIX with the mix
    factor + second-leaf parameters (leaf A rides the base slots via
    mix_first, which is the identity for non-mix rows)."""
    origin, horizontal, vertical, lower_left = scene.camera.ray_origin()
    bg = scene.background
    bg_a = bg.color_a
    bg_b = bg.color_b if bg.color_b is not None else bg.color_a
    head = jnp.concatenate([
        origin, horizontal, vertical, lower_left,
        bg_a, bg_b,
        jnp.array([1.0 / (width - 1), 1.0 / (height - 1)], jnp.float32),
    ])
    mats = scene.materials
    mat_id = scene.spheres.material
    mid_a = mats.mix_first[mat_id] if mix else mat_id
    cols = [
        scene.spheres.center,                       # cx cy cz
        scene.spheres.radius[:, None],              # r
        mats.albedo[mid_a],                         # al_r al_g al_b
        mats.fuzz[mid_a][:, None],                  # fuzz
        mats.ir[mid_a][:, None],                    # ir
        mats.emission[mid_a],                       # em_r em_g em_b
    ]
    if mix:
        mid_b = mats.mix_second[mat_id]
        cols += [
            mats.mix_factor[mat_id][:, None],       # factor
            mats.albedo[mid_b],                     # al2
            mats.fuzz[mid_b][:, None],              # fuzz2
            mats.ir[mid_b][:, None],                # ir2
            mats.emission[mid_b],                   # em2
        ]
    if scene.spheres.num_volumes > 0:
        cols += [scene.spheres.neg_inv_density[:, None]]  # nid (0 = solid)
    per_sphere = jnp.concatenate(cols, axis=1).reshape(-1)
    return jnp.concatenate([head, per_sphere]).astype(jnp.float32)


def sphere_kinds(scene: Scene) -> tuple:
    """Per-sphere static material kinds: an int for plain materials, an
    (kind_a, kind_b) pair for single-level mixes (the kernel blends the two
    baked leaves with the bounce's mix coin)."""
    kinds = np.asarray(scene.materials.kind)
    first = np.asarray(scene.materials.mix_first)
    second = np.asarray(scene.materials.mix_second)
    out = []
    for m in np.asarray(scene.spheres.material):
        if kinds[m] == M.MIX:
            out.append((int(kinds[first[m]]), int(kinds[second[m]])))
        else:
            out.append(int(kinds[m]))
    return tuple(out)


def _flat_kinds(kind_entries) -> set:
    """Flatten sphere_kinds entries (ints and (a, b) mix pairs) to a set."""
    out = set()
    for k in kind_entries:
        if isinstance(k, tuple):
            out.update(k)
        else:
            out.add(k)
    return out


def _prep_rays(pixel_ids, spp: int, width: int, block: int, sample_offset=0,
               n_samples: int | None = None):
    """(pixel, sample) fan-out -> flat (ray_ids, px, py), padded to a
    multiple of ``block``, plus the real ray count.

    ``sample_offset``/``n_samples`` select a slice of each pixel's sample
    range (spp sharding: parallel/distributed.py); ray ids stay GLOBAL
    (pixel * spp + global sample index) so any decomposition consumes the
    same uniforms.  ``sample_offset`` may be traced (axis_index inside
    shard_map)."""
    if n_samples is None:
        n_samples = spp
    n_rays = pixel_ids.shape[0] * n_samples
    sample_ids = sample_offset + jnp.arange(n_samples, dtype=jnp.int32)
    ray_ids = (pixel_ids[:, None] * spp + sample_ids[None, :]).reshape(-1)
    pid = jnp.repeat(pixel_ids, n_samples)
    px = (pid % width).astype(jnp.float32)
    py = (pid // width).astype(jnp.float32)
    pad = (-n_rays) % block
    if pad:
        ray_ids = jnp.concatenate([ray_ids, jnp.zeros(pad, jnp.int32)])
        px = jnp.concatenate([px, jnp.zeros(pad, jnp.float32)])
        py = jnp.concatenate([py, jnp.zeros(pad, jnp.float32)])
    return ray_ids, px, py, n_rays


def pixel_radiance_pallas(scene: Scene, pixel_ids, width: int, height: int,
                          iparams, *, kinds: tuple | None = None,
                          interpret: bool = False,
                          sample_offset=0, n_samples: int | None = None,
                          block: int = FWD_BLOCK, num_warps: int = FWD_WARPS,
                          grad_block: int = GRAD_BLOCK,
                          grad_warps: int = GRAD_WARPS):
    """Mean clamped radiance per pixel -> (P, 3), via the kernel.

    Drop-in twin of render.pixel_radiance for supported scenes.
    ``iparams``: the (2,) int32 seed words — an array, so re-seeding never
    recompiles.  ``kinds`` (static, from :func:`sphere_kinds`) must be
    supplied when the scene is traced.  ``interpret`` runs the kernels in
    the Pallas interpreter (CPU tests).  ``sample_offset``/``n_samples``
    restrict to a sample slice (spp sharding) — the returned mean is over
    that LOCAL slice; the caller psums across the spp mesh axis.
    ``block``/``num_warps`` (forward) and ``grad_*`` (backward) set the
    launch shape.
    The caller checks :func:`supports` on the concrete scene
    (render.resolve_engine): here the scene may be traced.
    """
    if kinds is None:
        kinds = sphere_kinds(scene)
    spp = scene.settings.samples_per_pixel
    p = pixel_ids.shape[0]
    n_local = n_samples if n_samples is not None else spp
    align = max(block, grad_block)
    ray_ids, px, py, n_rays = _prep_rays(pixel_ids, spp, width, align,
                                         sample_offset, n_samples)
    fparams = _pack_fparams(scene, width, height,
                            mix=bool(scene.materials.has_mix))
    radiance_fn = _radiance_cvjp(_static_cfg(scene, kinds),
                                 ray_ids.shape[0], interpret, block,
                                 num_warps, grad_block, grad_warps)
    outs = radiance_fn(fparams, iparams, ray_ids, px, py)
    if scene.background.kind == B.SKYMAP:
        radiance = _env_finish(scene, outs, n_rays)
    else:
        radiance = jnp.stack([o[:n_rays] for o in outs], axis=-1)
    radiance = jnp.clip(radiance, 0.0, scene.settings.clamp_indirect)
    return radiance.reshape(p, n_local, 3).mean(axis=1)


def mse_loss_pallas(scene: Scene, target, width: int, height: int, iparams,
                    *, kinds: tuple | None = None, interpret: bool = False,
                    block: int = FWD_BLOCK, num_warps: int = FWD_WARPS,
                    grad_block: int = GRAD_BLOCK,
                    grad_warps: int = GRAD_WARPS):
    """jnp.mean((render_linear(scene) - target)**2) over the FULL frame
    with a FUSED loss+gradient kernel: under value_and_grad the whole fit
    step is one kernel launch (no separate forward render).  ``target`` is
    (H, W, 3) linear radiance and is treated as a CONSTANT of the fit (its
    cotangent is zero).  Gate (checked by the caller on the concrete
    scene): :func:`supports_fused_mse`.
    """
    if kinds is None:
        kinds = sphere_kinds(scene)
    spp = scene.settings.samples_per_pixel
    # each pixel's samples fill a power-of-two group of rays; real rays
    # keep GLOBAL ids pixel*spp + s, so the gradients match the two-pass
    # path; pad rays trace throwaway samples the loss ignores
    spp_pad = _pow2(spp)
    grad_block = max(grad_block, spp_pad)
    n_pixels = width * height
    pixel_ids = jnp.arange(n_pixels, dtype=jnp.int32)
    ray_ids, px, py, _ = _prep_rays(pixel_ids, spp, width,
                                    max(block, grad_block), 0, spp_pad)
    n_pad = ray_ids.shape[0]
    fparams = _pack_fparams(scene, width, height,
                            mix=bool(scene.materials.has_mix))

    # per-pixel targets + exact-mean weights (pad pixels weigh 0)
    t3 = jax.lax.stop_gradient(jnp.asarray(target)).reshape(n_pixels, 3)
    pix_pad = n_pad // spp_pad - n_pixels
    t3 = jnp.concatenate([t3, jnp.zeros((pix_pad, 3), jnp.float32)])
    tgt = tuple(t3[:, c] for c in range(3))
    wt = jnp.concatenate([
        jnp.full((n_pixels,), 1.0 / (3.0 * n_pixels), jnp.float32),
        jnp.zeros((pix_pad,), jnp.float32)])

    loss_fn = _mse_cvjp(_static_cfg(scene, kinds), n_pad, interpret, spp,
                        spp_pad, float(scene.settings.clamp_indirect),
                        block, num_warps, grad_block, grad_warps)
    return loss_fn(fparams, tgt, wt, iparams, ray_ids, px, py)
