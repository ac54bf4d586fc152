"""Fused differentiable tracer: forward+backward Pallas kernels for CUDA
GPUs (Triton route).

The general differentiable path is the rematerialized XLA bounce scan
(`ops.integrator.trace(differentiable=True)`), which runs every lane
through all `max_depth` bounces and round-trips the state through device
memory per bounce. This module is the fast tier for the scenes
gradient-based training actually uses: the WHOLE multi-bounce trace runs
as ONE Pallas kernel per lane block (state stays in registers across
bounces), and the backward pass is a SECOND Pallas kernel that replays
the trace in-kernel and applies reverse-mode cotangents.

The backward kernel is NOT hand-derived: the bounce math is a pure
jnp function over (BLOCK,) lane vectors, and the kernel body calls
`jax.vjp` on it — transposition happens at TRACE time, so Triton
compiles the exact adjoint arithmetic autodiff would produce. Agreement
with the XLA tier's `jax.grad` is therefore structural, and pinned by
tests/test_pallas_grad.py in interpret mode.

Like the forward kernel, the program is feature-gated STATICALLY per scene:
each primitive's kind (sphere/rect) and the set of material families
present are compile-time constants, so a rect-only lambertian scene
(the production inverse render) traces none of the sphere/metal/
dielectric math — this also keeps the unrolled-trace compile time
proportional to what the scene actually uses.

Feature scope (gate: `supports_fast_grad`): spheres + rects (incl.
rotated/translated instances — the math uses the hoisted world-frame
pack), lambertian / metal / dielectric / diffuse_light, solid and
3D-checker textures (checker needs no uv — it is a pure function of
the hit point), both backgrounds, no media, no motion blur, no russian
roulette. That
covers the production inverse-render scene (examples/inverse_render.py)
and the bench gradient-probe family; everything else falls back to the
XLA scan — same contract as the forward kernel's UnsupportedScene.

Reference parity: the bounce math mirrors ops/integrator._bounce (and
therefore reference src/color.rs:6-23 + src/material.rs) exactly; the
one numeric substitution is cbrt(x) = exp(log(x)/3) in the unit-ball
radius, which agrees to f32 ulps.
"""

from __future__ import annotations

import functools
from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..models.scene import (SceneTables, BG_SKY, MAT_LAMBERTIAN, MAT_METAL,
                            MAT_DIELECTRIC, MAT_DIFFUSE_LIGHT, TEX_SOLID,
                            TEX_CHECKER)
from .intersect import BIG, pack_prims
from . import rng

T_MIN = 1e-3  # reference src/color.rs:7

# one lane per thread: the unrolled vjp keeps many values live per lane,
# so a lane never shares a thread's registers with another
NUM_WARPS = 4
BLOCK = 32 * NUM_WARPS

# record columns (f32[P, C]); built differentiably by fast_grad_record
C_IS_SPHERE = 0
C_CX, C_CY, C_CZ = 1, 2, 3
C_R2 = 4
C_INVR = 5
C_KN = 6    # 6..8  rect plane normal (world frame)
C_AN = 9    # 9..11
C_BN = 12   # 12..14
C_KOFF = 15
C_AOFF = 16
C_BOFF = 17
C_A0, C_A1, C_B0, C_B1 = 18, 19, 20, 21
C_FLIP = 22
C_LAMB, C_METAL, C_DIEL, C_LIGHT = 23, 24, 25, 26
C_PARAM = 27
C_TEX_E = 28  # 28..30 texture EVEN color (the solid color for solids)
C_TEX_O = 31  # 31..33 texture ODD color (checker only)
C_CHK = 34    # 1.0 ⇒ 3D-checker texture (reference src/texture.rs:40-47)
REC_C = 35

MAX_PRIMS = 64    # unrolled in-kernel loop; compile-size gate
MAX_DEPTH = 16    # unrolled bounce loop


def supports_fast_grad(scene: SceneTables, max_depth: int,
                       rr_depth=None) -> bool:
    """Static gate for the fused kernel's feature scope (see module
    docstring). Mirrors the forward kernel's support policy: run
    fast when legal, fall back to the general XLA path otherwise."""
    import numpy as np
    if rr_depth is not None or max_depth > MAX_DEPTH:
        return False
    if scene.has_media or scene.num_prims > MAX_PRIMS:
        return False
    ptype = np.asarray(scene.prim_type)
    from ..models.scene import PRIM_MOVING_SPHERE
    if (ptype == PRIM_MOVING_SPHERE).any():
        return False
    mtypes = np.asarray(scene.mat_type)[np.asarray(scene.prim_material)]
    if not np.isin(mtypes, [MAT_LAMBERTIAN, MAT_METAL, MAT_DIELECTRIC,
                            MAT_DIFFUSE_LIGHT]).all():
        return False
    texs = np.asarray(scene.mat_texture)[np.asarray(scene.prim_material)]
    ttypes = np.asarray(scene.tex_type)
    for t in texs:
        if ttypes[t] == TEX_SOLID:
            continue
        if ttypes[t] == TEX_CHECKER:
            # 3D checker of SOLID children (the only nesting the
            # reference ever builds, tests/test.rs:93-101)
            c0, c1 = np.asarray(scene.tex_child)[t]
            if ttypes[c0] == TEX_SOLID and ttypes[c1] == TEX_SOLID:
                continue
        return False
    return True


def fast_grad_config(scene: SceneTables):
    """(kinds, feats): compile-time structure of the kernel program.

    kinds: per-prim "s"/"r"; feats: frozenset of families present
    among USED materials/textures ("metal", "diel", "light",
    "checker"; lambertian+solid is the free default).

    Needs CONCRETE scene tables — under jit, compute it once outside
    and pass it to trace_fast(cfg=...) (the config is static program
    structure, exactly like the forward kernel's per-scene gating).
    """
    import numpy as np
    from ..models.scene import PRIM_RECT
    ptype = np.asarray(scene.prim_type)
    kinds = tuple("r" if t == PRIM_RECT else "s" for t in ptype)
    mtypes = np.asarray(scene.mat_type)[np.asarray(scene.prim_material)]
    feats = set()
    if (mtypes == MAT_METAL).any():
        feats.add("metal")
    if (mtypes == MAT_DIELECTRIC).any():
        feats.add("diel")
    if (mtypes == MAT_DIFFUSE_LIGHT).any():
        feats.add("light")
    if scene.background == BG_SKY:
        feats.add("sky")
    texs = np.asarray(scene.mat_texture)[np.asarray(scene.prim_material)]
    if (np.asarray(scene.tex_type)[texs] == TEX_CHECKER).any():
        feats.add("checker")
    return kinds, frozenset(feats)


def fast_grad_record(scene: SceneTables) -> jnp.ndarray:
    """SceneTables → dense per-prim record f32[P, REC_C], built with
    differentiable jnp ops so `jax.grad` through the kernel's d_record
    chains back into prim_data / mat_param / tex_color by ordinary XLA
    transposition (the kernel's custom_vjp only covers the Pallas part).
    """
    pack = pack_prims(scene)  # hoisted world-frame quantities (shared impl)
    P = scene.num_prims
    f = lambda x: x.astype(jnp.float32)
    is_sph = f(pack.is_sphere)
    radius = pack.radius
    invr = jnp.where(pack.is_sphere, 1.0 / jnp.where(radius == 0.0, 1.0,
                                                     radius), 0.0)
    mat = scene.prim_material
    mtype = scene.mat_type[mat]
    tex = scene.mat_texture[mat]
    is_chk = scene.tex_type[tex] == TEX_CHECKER
    # checker: tex_child[t] = (odd, even) — textures.py:25-26; the odd
    # child wins where sin(10x)·sin(10y)·sin(10z) < 0. For solids both
    # slots carry the solid color (odd is never selected: chk flag 0).
    even = scene.tex_color[jnp.where(is_chk, scene.tex_child[tex, 1], tex)]
    odd = scene.tex_color[jnp.where(is_chk, scene.tex_child[tex, 0], tex)]
    is_light = mtype == MAT_DIFFUSE_LIGHT
    cols = [
        is_sph,
        pack.c0[:, 0], pack.c0[:, 1], pack.c0[:, 2],
        pack.r2, invr,
        pack.kn[:, 0], pack.kn[:, 1], pack.kn[:, 2],
        pack.an[:, 0], pack.an[:, 1], pack.an[:, 2],
        pack.bn[:, 0], pack.bn[:, 1], pack.bn[:, 2],
        pack.k_off, pack.a_off, pack.b_off,
        pack.a0, pack.a1, pack.b0, pack.b1,
        scene.prim_flip.astype(jnp.float32),
        f(mtype == MAT_LAMBERTIAN), f(mtype == MAT_METAL),
        f(mtype == MAT_DIELECTRIC), f(is_light),
        scene.mat_param[mat],
        even[:, 0], even[:, 1], even[:, 2],
        odd[:, 0], odd[:, 1], odd[:, 2],
        is_chk.astype(jnp.float32),
    ]
    assert len(cols) == REC_C
    rec = jnp.stack(cols, axis=1)
    assert rec.shape == (P, REC_C)
    return rec


# ---------------------------------------------------------------------------
# In-kernel math: pure jnp over (BLOCK,) lane vectors. `scal` is a
# [P][REC_C] nested list of traced scalars — python loops over it unroll, and
# jax.vjp over the whole structure gives per-scalar adjoints the backward
# kernel writes into d_record.
# ---------------------------------------------------------------------------

def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _trace_tiles(scal, o, d, u, kinds, feats, n_bounce: int,
                 max_depth: int):
    """The full multi-bounce trace on one lane block.

    scal: [P][REC_C] scalars; o, d: 3-tuples of (BLOCK,) lane vectors;
    u: [n_bounce][4] lane vectors (draw columns as integrator._lane_draws);
    kinds/feats: the static program structure (fast_grad_config).
    Returns (rr, rg, rb) radiance tiles. Mirrors integrator._bounce /
    trace for the supported scope — see module docstring.
    """
    f = jnp.float32
    any_s = "s" in kinds
    any_r = "r" in kinds
    has_metal = "metal" in feats
    has_diel = "diel" in feats
    has_light = "light" in feats
    has_checker = "checker" in feats
    bg_sky = "sky" in feats
    ox, oy, oz = o
    dx, dy, dz = d
    shape = ox.shape
    thr_r = thr_g = thr_b = jnp.ones(shape, f)
    rad_r = rad_g = rad_b = jnp.zeros(shape, f)
    alive = jnp.ones(shape, f)  # f32 mask: multiplies into the gain
    zero = jnp.zeros(shape, f)

    for b in range(n_bounce):
        u0, u1, u2, u3 = u[b]

        # ---- closest hit: unrolled prim loop (integrator/intersect math,
        # first-strict-min tie-break == jnp.argmin's first-index rule).
        # Each prim evaluates ONLY its kind's candidate (static), and
        # updates only the attribute carries its kind can win (a stale
        # other-kind attribute is masked off by w_sph at use sites, and
        # its gradient is killed by the same mask's transpose). ----
        t_best = jnp.full(shape, f(BIG))
        w_sph = zero if (any_s and any_r) else None
        w_cx = w_cy = w_cz = zero
        w_invr = zero
        w_knx = w_kny = w_knz = zero
        w_flip = jnp.ones(shape, f)
        w_light_c = zero
        w_metal = w_diel = zero
        w_par = zero
        w_ter = w_teg = w_teb = zero      # texture even color
        w_tor = w_tog = w_tob = zero      # texture odd color (checker)
        w_chk = zero

        a_dd = _dot3(dx, dy, dz, dx, dy, dz)
        inv_a = f(1.0) / a_dd

        for p, kind in enumerate(kinds):
            r = scal[p]
            if kind == "s":
                # sphere candidate (reference src/sphere.rs:37-77; oc
                # formed difference-first — intersect.py numerics note)
                ocx = ox - r[C_CX]
                ocy = oy - r[C_CY]
                ocz = oz - r[C_CZ]
                bq = _dot3(ocx, ocy, ocz, dx, dy, dz)
                cc = _dot3(ocx, ocy, ocz, ocx, ocy, ocz) - r[C_R2]
                disc = bq * bq - a_dd * cc
                pos = disc > f(0.0)
                sq = jnp.sqrt(jnp.where(pos, disc, f(1.0)))  # double-where
                t_near = (-bq - sq) * inv_a
                t_far = (-bq + sq) * inv_a
                near_ok = pos & (t_near > f(T_MIN)) & (t_near < f(BIG))
                far_ok = pos & (t_far > f(T_MIN)) & (t_far < f(BIG))
                t_p = jnp.where(near_ok, t_near,
                                jnp.where(far_ok, t_far, f(BIG)))
            else:
                # rect candidate (reference src/rect.rs:39-69, world frame)
                o_kn = _dot3(ox, oy, oz, r[C_KN], r[C_KN + 1], r[C_KN + 2])
                d_kn = _dot3(dx, dy, dz, r[C_KN], r[C_KN + 1], r[C_KN + 2])
                par_m = d_kn == f(0.0)
                t_r = (r[C_KOFF] - o_kn) / jnp.where(par_m, f(1.0), d_kn)
                xx = (_dot3(ox, oy, oz, r[C_AN], r[C_AN + 1], r[C_AN + 2])
                      + t_r * _dot3(dx, dy, dz, r[C_AN], r[C_AN + 1],
                                    r[C_AN + 2]) - r[C_AOFF])
                yy = (_dot3(ox, oy, oz, r[C_BN], r[C_BN + 1], r[C_BN + 2])
                      + t_r * _dot3(dx, dy, dz, r[C_BN], r[C_BN + 1],
                                    r[C_BN + 2]) - r[C_BOFF])
                rect_ok = ((~par_m) & (t_r > f(T_MIN)) & (t_r < f(BIG))
                           & (xx >= r[C_A0]) & (xx <= r[C_A1])
                           & (yy >= r[C_B0]) & (yy <= r[C_B1]))
                t_p = jnp.where(rect_ok, t_r, f(BIG))

            better = t_p < t_best
            t_best = jnp.where(better, t_p, t_best)
            if w_sph is not None:
                w_sph = jnp.where(better, r[C_IS_SPHERE], w_sph)
            if kind == "s":
                w_cx = jnp.where(better, r[C_CX], w_cx)
                w_cy = jnp.where(better, r[C_CY], w_cy)
                w_cz = jnp.where(better, r[C_CZ], w_cz)
                w_invr = jnp.where(better, r[C_INVR], w_invr)
            else:
                w_knx = jnp.where(better, r[C_KN], w_knx)
                w_kny = jnp.where(better, r[C_KN + 1], w_kny)
                w_knz = jnp.where(better, r[C_KN + 2], w_knz)
            w_flip = jnp.where(better, r[C_FLIP], w_flip)
            if has_light:
                w_light_c = jnp.where(better, r[C_LIGHT], w_light_c)
            if has_metal or has_diel:
                w_par = jnp.where(better, r[C_PARAM], w_par)
            if has_metal:
                w_metal = jnp.where(better, r[C_METAL], w_metal)
            if has_diel:
                w_diel = jnp.where(better, r[C_DIEL], w_diel)
            w_ter = jnp.where(better, r[C_TEX_E], w_ter)
            w_teg = jnp.where(better, r[C_TEX_E + 1], w_teg)
            w_teb = jnp.where(better, r[C_TEX_E + 2], w_teb)
            if has_checker:
                w_tor = jnp.where(better, r[C_TEX_O], w_tor)
                w_tog = jnp.where(better, r[C_TEX_O + 1], w_tog)
                w_tob = jnp.where(better, r[C_TEX_O + 2], w_tob)
                w_chk = jnp.where(better, r[C_CHK], w_chk)

        hit = (t_best < f(BIG)).astype(f)
        t_safe = jnp.where(t_best < f(BIG), t_best, f(0.0))
        px = ox + t_safe * dx
        py = oy + t_safe * dy
        pz = oz + t_safe * dz

        # normal (sphere: (p−c)/r; rect: kn) × flip — intersect.py:311-341
        if any_s and any_r:
            sphw = w_sph > f(0.5)
            nx = jnp.where(sphw, (px - w_cx) * w_invr, w_knx) * w_flip
            ny = jnp.where(sphw, (py - w_cy) * w_invr, w_kny) * w_flip
            nz = jnp.where(sphw, (pz - w_cz) * w_invr, w_knz) * w_flip
        elif any_s:
            nx = (px - w_cx) * w_invr * w_flip
            ny = (py - w_cy) * w_invr * w_flip
            nz = (pz - w_cz) * w_invr * w_flip
        else:
            nx, ny, nz = w_knx * w_flip, w_kny * w_flip, w_knz * w_flip

        # winner texture value (textures.py eval_texture for the solid/
        # checker scope): checker picks the ODD color where
        # sin(10x)·sin(10y)·sin(10z) < 0 (reference src/texture.rs:40-47)
        if has_checker:
            sines = (jnp.sin(f(10.0) * px) * jnp.sin(f(10.0) * py)
                     * jnp.sin(f(10.0) * pz))
            use_odd = (w_chk > f(0.5)) & (sines < f(0.0))
            w_alr = jnp.where(use_odd, w_tor, w_ter)
            w_alg = jnp.where(use_odd, w_tog, w_teg)
            w_alb = jnp.where(use_odd, w_tob, w_teb)
        else:
            w_alr, w_alg, w_alb = w_ter, w_teg, w_teb

        # emitted on every hit (reference src/color.rs:8-15): the
        # light's texture value, zero for non-lights (materials.py
        # emitted)
        gain = alive * hit
        if has_light:
            gl = gain * w_light_c
            rad_r = rad_r + gl * thr_r * w_alr
            rad_g = rad_g + gl * thr_g * w_alg
            rad_b = rad_b + gl * thr_b * w_alb

        # miss → background, die (src/color.rs:16-22)
        if bg_sky:
            miss = alive * (f(1.0) - hit)
            inv_len = jax.lax.rsqrt(a_dd)
            tt = f(0.5) * (dy * inv_len + f(1.0))
            bgr = (f(1.0) - tt) + tt * f(0.5)
            bgg = (f(1.0) - tt) + tt * f(0.7)
            bgb = (f(1.0) - tt) + tt * f(1.0)
            rad_r = rad_r + miss * thr_r * bgr
            rad_g = rad_g + miss * thr_g * bgg
            rad_b = rad_b + miss * thr_b * bgb

        if b == max_depth:
            # final bounce only collects (src/color.rs:9 depth<50 gate)
            alive = jnp.zeros(shape, f)
            continue

        # ---- scatter (materials.py, reference src/material.rs) ----
        # unit ball sample; cbrt via exp(log/3)
        cos_t = f(2.0) * u0 - f(1.0)
        sin_t = jnp.sqrt(jnp.maximum(f(0.0), f(1.0) - cos_t * cos_t))
        phi = f(2.0 * 3.14159265358979) * u1
        # radius from 1−u: (0,1] — u=0 would make a zero vector (rng.py)
        rr3 = jnp.exp(jnp.log(f(1.0) - u2) * f(1.0 / 3.0))
        ssx = rr3 * sin_t * jnp.cos(phi)
        ssy = rr3 * sin_t * jnp.sin(phi)
        ssz = rr3 * cos_t

        # lambertian: n + ball (src/material.rs:49-53)
        ndx, ndy, ndz = nx + ssx, ny + ssy, nz + ssz
        ok = jnp.ones(shape, f)

        if has_metal or has_diel:
            inv_len = jax.lax.rsqrt(a_dd)
            ux_, uy_, uz_ = dx * inv_len, dy * inv_len, dz * inv_len

        if has_metal:
            # metal: reflect(unit d) + fuzz·ball (src/material.rs:76-87)
            udn = _dot3(ux_, uy_, uz_, nx, ny, nz)
            rfx = ux_ - f(2.0) * udn * nx + w_par * ssx
            rfy = uy_ - f(2.0) * udn * ny + w_par * ssy
            rfz = uz_ - f(2.0) * udn * nz + w_par * ssz
            metal_ok = (_dot3(rfx, rfy, rfz, nx, ny, nz)
                        > f(0.0)).astype(f)
            is_metal = w_metal > f(0.5)
            ndx = jnp.where(is_metal, rfx, ndx)
            ndy = jnp.where(is_metal, rfy, ndy)
            ndz = jnp.where(is_metal, rfz, ndz)
            ok = jnp.where(is_metal, metal_ok, ok)

        if has_diel:
            # dielectric (src/material.rs:105-126); double-where guards
            # as in materials.py (param-0 rows, TIR lanes)
            is_diel = w_diel > f(0.5)
            ref_idx = jnp.where(is_diel, w_par, f(1.0))
            ddn = _dot3(dx, dy, dz, nx, ny, nz)
            d_len = jnp.sqrt(a_dd)
            exiting = ddn > f(0.0)
            sgn = jnp.where(exiting, f(-1.0), f(1.0))
            onx, ony, onz = sgn * nx, sgn * ny, sgn * nz
            ni_over_nt = jnp.where(exiting, ref_idx, f(1.0) / ref_idx)
            cosine = jnp.where(exiting, ref_idx * ddn / d_len,
                               -ddn / d_len)
            # refract(v=d, n=outward, eta) — materials.py _refract
            uvdt = _dot3(ux_, uy_, uz_, onx, ony, onz)
            disc_r = (f(1.0) - ni_over_nt * ni_over_nt
                      * (f(1.0) - uvdt * uvdt))
            can_refract = disc_r > f(0.0)
            sq_r = jnp.sqrt(jnp.where(can_refract, disc_r, f(1.0)))
            refx = ni_over_nt * (ux_ - onx * uvdt) - onx * sq_r
            refy = ni_over_nt * (uy_ - ony * uvdt) - ony * sq_r
            refz = ni_over_nt * (uz_ - onz * uvdt) - onz * sq_r
            r0 = ((f(1.0) - ref_idx) / (f(1.0) + ref_idx)) ** 2
            one_mc = f(1.0) - cosine
            schlick = r0 + (f(1.0) - r0) * one_mc ** 5
            reflect_prob = jnp.where(can_refract, schlick, f(1.0))
            take_refract = can_refract & (u3 >= reflect_prob)
            # pure reflect of UNNORMALIZED d (materials.py else-branch)
            prx = dx - f(2.0) * ddn * nx
            pry = dy - f(2.0) * ddn * ny
            prz = dz - f(2.0) * ddn * nz
            ndx = jnp.where(is_diel,
                            jnp.where(take_refract, refx, prx), ndx)
            ndy = jnp.where(is_diel,
                            jnp.where(take_refract, refy, pry), ndy)
            ndz = jnp.where(is_diel,
                            jnp.where(take_refract, refz, prz), ndz)

        if has_light:
            ok = ok * (f(1.0) - w_light_c)  # light never scatters

        if has_diel:
            atr = jnp.where(is_diel, f(1.0), w_alr)
            atg = jnp.where(is_diel, f(1.0), w_alg)
            atb = jnp.where(is_diel, f(1.0), w_alb)
        else:
            atr, atg, atb = w_alr, w_alg, w_alb

        cont = gain * ok
        keep = cont > f(0.5)
        thr_r = jnp.where(keep, thr_r * atr, thr_r)
        thr_g = jnp.where(keep, thr_g * atg, thr_g)
        thr_b = jnp.where(keep, thr_b * atb, thr_b)
        ox = jnp.where(keep, px, ox)
        oy = jnp.where(keep, py, oy)
        oz = jnp.where(keep, pz, oz)
        dx = jnp.where(keep, ndx, dx)
        dy = jnp.where(keep, ndy, dy)
        dz = jnp.where(keep, ndz, dz)
        alive = cont

    return rad_r, rad_g, rad_b


def _read_scal(rec_ref, P):
    return [[rec_ref[p, c] for c in range(REC_C)] for p in range(P)]


def _fwd_kernel(rec_ref, od_ref, u_ref, rad_ref, *, kinds, feats,
                n_bounce, max_depth):
    scal = _read_scal(rec_ref, len(kinds))
    o = (od_ref[0], od_ref[1], od_ref[2])
    d = (od_ref[3], od_ref[4], od_ref[5])
    u = [[u_ref[b, c] for c in range(4)] for b in range(n_bounce)]
    rr, rg, rb = _trace_tiles(scal, o, d, u, kinds, feats, n_bounce,
                              max_depth)
    rad_ref[0] = rr
    rad_ref[1] = rg
    rad_ref[2] = rb


def _bwd_kernel(rec_ref, od_ref, u_ref, ct_ref, dod_ref, drec_ref, *,
                kinds, feats, n_bounce, max_depth):
    """Replay the trace in-kernel and apply reverse-mode cotangents.

    jax.vjp runs at TRACE time over the same _trace_tiles the forward
    kernel lowers — the adjoint Triton compiles is autodiff's own, so
    fast-tier grads match the XLA tier's structurally (module docstring).
    """
    P = len(kinds)
    scal = _read_scal(rec_ref, P)
    o = (od_ref[0], od_ref[1], od_ref[2])
    d = (od_ref[3], od_ref[4], od_ref[5])
    u = [[u_ref[b, c] for c in range(4)] for b in range(n_bounce)]

    def fn(scal, o, d):
        return _trace_tiles(scal, o, d, u, kinds, feats, n_bounce,
                            max_depth)

    _, vjp = jax.vjp(fn, scal, o, d)
    d_scal, d_o, d_d = vjp((ct_ref[0], ct_ref[1], ct_ref[2]))
    for i in range(3):
        dod_ref[i] = d_o[i]
        dod_ref[3 + i] = d_d[i]
    for p in range(P):
        for c in range(REC_C):
            g = d_scal[p][c]
            drec_ref[0, p, c] = (jnp.zeros((), jnp.float32)
                                 if g is None else g)


@functools.lru_cache(maxsize=None)
def _make_traced(kinds, feats, n_bounce: int, max_depth: int, nb: int,
                 interpret: bool):
    """custom_vjp'd (rec, od, u) → rad for one static config.

    od: f32[6, nb·BLOCK]; u: f32[n_bounce, 4, nb·BLOCK];
    rad: f32[3, nb·BLOCK]. nb = lane blocks (grid dim).
    `interpret` is part of the cache key (an interpret-mode test and a
    compiled run can share one process).
    """
    P = len(kinds)
    grid = (nb,)
    rec_spec = pl.BlockSpec((P, REC_C), lambda i: (0, 0))
    od_spec = pl.BlockSpec((6, BLOCK), lambda i: (0, i))
    u_spec = pl.BlockSpec((n_bounce, 4, BLOCK), lambda i: (0, 0, i))
    rad_spec = pl.BlockSpec((3, BLOCK), lambda i: (0, i))
    params = plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1)

    fwd_call = pl.pallas_call(
        partial(_fwd_kernel, kinds=kinds, feats=feats, n_bounce=n_bounce,
                max_depth=max_depth),
        grid=grid,
        in_specs=[rec_spec, od_spec, u_spec],
        out_specs=rad_spec,
        out_shape=jax.ShapeDtypeStruct((3, nb * BLOCK), jnp.float32),
        backend="triton",
        compiler_params=params,
        interpret=interpret,
        name="rt_grad_fwd",
    )

    bwd_call = pl.pallas_call(
        partial(_bwd_kernel, kinds=kinds, feats=feats, n_bounce=n_bounce,
                max_depth=max_depth),
        grid=grid,
        in_specs=[rec_spec, od_spec, u_spec, rad_spec],
        out_specs=(
            pl.BlockSpec((6, BLOCK), lambda i: (0, i)),
            pl.BlockSpec((1, P, REC_C), lambda i: (i, 0, 0)),
        ),
        out_shape=(
            jax.ShapeDtypeStruct((6, nb * BLOCK), jnp.float32),
            jax.ShapeDtypeStruct((nb, P, REC_C), jnp.float32),
        ),
        backend="triton",
        compiler_params=params,
        interpret=interpret,
        name="rt_grad_bwd",
    )

    @jax.custom_vjp
    def traced(rec, od, u):
        return fwd_call(rec, od, u)

    def traced_fwd(rec, od, u):
        return fwd_call(rec, od, u), (rec, od, u)

    def traced_bwd(res, ct):
        rec, od, u = res
        d_od, d_rec_blocks = bwd_call(rec, od, u, ct)
        # per-block partial table grads sum outside the kernel (nb is
        # small; a cross-block in-kernel accumulation would need
        # output aliasing for no measurable win)
        return d_rec_blocks.sum(axis=0), d_od, jnp.zeros_like(u)

    traced.defvjp(traced_fwd, traced_bwd)
    return traced


def fast_draws(key, n_lanes: int, n_bounce: int, lane_keyed: bool = False):
    """The trace's U[0,1) draw tensor [n_bounce, 4, N].

    lane_keyed=True reproduces the XLA tier's per-lane stream
    (rng.lane_uniforms — bit-comparable paths, used by the parity
    tests); the default is ONE fused threefry draw — statistically
    identical, ~n_bounce·N times fewer key folds.
    """
    if lane_keyed:
        lane = jnp.arange(n_lanes, dtype=jnp.int32)
        u = jnp.stack([rng.lane_uniforms(key, b, lane, 4)
                       for b in range(n_bounce)])      # [B, N, 4]
        return jnp.transpose(u, (0, 2, 1))
    return jax.random.uniform(key, (n_bounce, 4, n_lanes), jnp.float32)


def trace_tiles_reference(scene: SceneTables, o, d, key,
                          max_depth: int = 50,
                          lane_keyed_draws: bool = False,
                          cfg=None) -> jnp.ndarray:
    """The SAME tile math as the kernels, run as plain jnp (no
    pallas_call) → f32[N, 3]. Exists for tests: interpret-mode
    pallas multiplies the in-kernel vjp's CPU compile cost ~30x, so
    the full-feature gradient-agreement test runs through this path
    (identical code) while the kernel plumbing is covered on small
    scenes. N must be a BLOCK multiple."""
    n = o.shape[0]
    assert n % BLOCK == 0
    n_bounce = max_depth + 1
    rec = fast_grad_record(scene)
    kinds, feats = cfg if cfg is not None else fast_grad_config(scene)
    scal = [[rec[p, c] for c in range(REC_C)] for p in range(len(kinds))]
    ot = tuple(o[:, i] for i in range(3))
    dt = tuple(d[:, i] for i in range(3))
    u = jax.lax.stop_gradient(fast_draws(key, n, n_bounce, lane_keyed_draws))
    ul = [[u[b, c] for c in range(4)] for b in range(n_bounce)]
    rr, rg, rb = _trace_tiles(scal, ot, dt, ul, kinds, feats, n_bounce,
                              max_depth)
    return jnp.stack([rr, rg, rb]).T


def trace_fast(scene: SceneTables, o, d, key, max_depth: int = 50,
               lane_keyed_draws: bool = False, cfg=None,
               interpret: bool = False) -> jnp.ndarray:
    """Differentiable radiance for a ray batch via the fused Pallas
    kernels → f32[N, 3]. Drop-in for the supported scope of
    `integrator.trace(..., differentiable=True)` (gate:
    supports_fast_grad; SAME estimator family, different RNG stream —
    callers that need path-matched target/candidate pairs must route
    BOTH through this function with the same key, as
    examples/inverse_render.py's fast path does).

    cfg: fast_grad_config(scene) — REQUIRED when scene is traced (jit):
    the kinds/feats program structure must be concrete.
    interpret: run both kernels in Pallas interpret mode (CPU tests)."""
    n = o.shape[0]
    n_bounce = max_depth + 1
    rec = fast_grad_record(scene)
    kinds, feats = cfg if cfg is not None else fast_grad_config(scene)
    pad = (-n) % BLOCK
    if pad:
        # padded lanes trace a harmless downward ray; sliced off below
        o = jnp.concatenate([o, jnp.zeros((pad, 3), o.dtype)])
        d = jnp.concatenate(
            [d, jnp.broadcast_to(jnp.asarray([0.0, 0.0, -1.0], d.dtype),
                                 (pad, 3))])
    nb = (n + pad) // BLOCK
    od = jnp.concatenate([o.T, d.T])
    u = jax.lax.stop_gradient(
        fast_draws(key, n + pad, n_bounce, lane_keyed_draws))
    traced = _make_traced(kinds, feats, n_bounce, max_depth, nb, interpret)
    rad = traced(rec, od, u)                    # [3, nb·BLOCK]
    return rad.T[:n]
