"""Batched ray/scene intersection — closest-hit over flat SoA tables.

The reference finds closest hits by walking trait objects per ray
(HittableList linear scan, reference src/hittable.rs:37-47; BVH recursion,
src/bvh.rs:70-89). This design inverts it into dense linear algebra:

* **Transform hoisting.** Traslate/Rotate instances (reference
  src/traslate.rs:18-24, src/rotate.rs:85-112) are rigid, so instead of
  rotating every (ray, prim) pair into object space we push the transform
  into per-primitive world-space quantities ONCE per trace call
  (`pack_prims`): sphere centers become `R·c + offset`; rects become a
  (plane normal, two in-plane axes, offsets) frame. Per-pair work then
  reduces to dot products.

* **Matmul formulation.** Every per-(ray, prim) dot product factors through
  [N,3] @ [3,C] contractions (`o·c'`, `d·c'`, `o·n̂`, `d·n̂`, ...), which XLA
  fuses/tiles natively — no [N, C, 3] intermediates ever materialize.

* **Two passes.** `closest_hit` scans primitive chunks carrying a running
  (t_best, idx_best); `hit_attributes` recomputes normal/uv only for each
  ray's single winning primitive.

Intersection semantics match the reference exactly: sphere quadratic with
near-then-far root and open (t_min, t_max) interval (src/sphere.rs:37-77),
moving-sphere center lerp (src/sphere.rs:115-118), axis-aligned rect bounds
test (src/rect.rs:39-69).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import jax
import jax.numpy as jnp

from ..models.scene import (SceneTables, PRIM_SPHERE, PRIM_MOVING_SPHERE,
                            PRIM_RECT, MED_SPHERE)

BIG = 3.0e38  # stand-in for f64::MAX at reference src/color.rs:7


def _mm(a, b):
    """[N,3] @ [3,C] as an explicit f32 elementwise contraction.

    Not a real matmul on purpose, twice over: (1) on the GPU an f32
    matmul may run in TF32 (~3 decimal digits) — at cornell-scale
    coordinates (~555) that rounds ray origins onto the wrong side of
    their own surface and every secondary ray self-intersects; (2) a K=3
    contraction would waste almost all of a tensor-core tile anyway. The
    unrolled K=3 elementwise form is exact f32 and fuses into the
    surrounding elementwise work.
    """
    return (a[:, 0:1] * b[0][None, :] + a[:, 1:2] * b[1][None, :]
            + a[:, 2:3] * b[2][None, :])


def _onehot3(idx: jnp.ndarray, dtype) -> jnp.ndarray:
    """[..., 3] one-hot for axis codes in {0, 1, 2}."""
    return (idx[..., None] == jnp.arange(3, dtype=jnp.int32)).astype(dtype)


def rot_plus(scene: SceneTables, xf_id: jnp.ndarray, v: jnp.ndarray):
    """Apply the object→world rotation of transform slot(s) `xf_id` to v.

    Componentwise form of reference src/rotate.rs:100-112: for rotation axis r
    with (a, b) = ((r+1)%3, (r+2)%3):
      out[a] = c·v[a] − s·v[b];  out[b] = s·v[a] + c·v[b];  out[r] = v[r].
    xf_id: int[...]; v: [..., 3] → [..., 3].
    """
    axis = scene.xf_axis[xf_id]
    s = scene.xf_sin[xf_id][..., None]
    c = scene.xf_cos[xf_id][..., None]
    dtype = v.dtype
    er = _onehot3(axis, dtype)
    ea = _onehot3((axis + 1) % 3, dtype)
    eb = _onehot3((axis + 2) % 3, dtype)
    va = jnp.sum(v * ea, -1, keepdims=True)
    vb = jnp.sum(v * eb, -1, keepdims=True)
    vr = jnp.sum(v * er, -1, keepdims=True)
    return vr * er + (c * va - s * vb) * ea + (s * va + c * vb) * eb


def rot_minus(scene: SceneTables, xf_id: jnp.ndarray, v: jnp.ndarray):
    """World→object rotation (reference src/rotate.rs:87-97), inverse of
    `rot_plus`."""
    axis = scene.xf_axis[xf_id]
    s = scene.xf_sin[xf_id][..., None]
    c = scene.xf_cos[xf_id][..., None]
    dtype = v.dtype
    er = _onehot3(axis, dtype)
    ea = _onehot3((axis + 1) % 3, dtype)
    eb = _onehot3((axis + 2) % 3, dtype)
    va = jnp.sum(v * ea, -1, keepdims=True)
    vb = jnp.sum(v * eb, -1, keepdims=True)
    vr = jnp.sum(v * er, -1, keepdims=True)
    return vr * er + (c * va + s * vb) * ea + (-s * va + c * vb) * eb


@jax.tree_util.register_dataclass
@dataclass
class PrimPack:
    """Per-primitive world-space quantities, computed once per trace call.

    Everything is differentiable back to SceneTables (geometry gradients flow
    through the pack).
    """
    is_sphere: jax.Array   # bool[P] (sphere or moving sphere)
    is_moving: jax.Array   # bool[P]
    is_rect: jax.Array     # bool[P]
    c0: jax.Array          # f32[P,3] world center at time0 (R·c0 + offset)
    dc: jax.Array          # f32[P,3] world center span (R·(c1−c0)); 0 if static
    t0: jax.Array          # f32[P] motion time0 (reference src/sphere.rs:115)
    inv_dt: jax.Array      # f32[P] 1/(time1−time0); 0 if static
    radius: jax.Array      # f32[P]
    r2: jax.Array          # f32[P] radius²
    kn: jax.Array          # f32[P,3] rect plane normal (world)
    an: jax.Array          # f32[P,3] rect a-axis (world)
    bn: jax.Array          # f32[P,3] rect b-axis (world)
    k_off: jax.Array       # f32[P] plane offset: k + offset·kn
    a_off: jax.Array       # f32[P] offset·an
    b_off: jax.Array       # f32[P] offset·bn
    a0: jax.Array          # f32[P] rect bounds
    a1: jax.Array
    b0: jax.Array
    b1: jax.Array


def pack_prims(scene: SceneTables) -> PrimPack:
    """Hoist instance transforms into world-space primitive quantities.

    Rigid-transform identity used for spheres: for the reference's
    world→object mapping p_obj = R₋(p − offset) (src/traslate.rs:18 +
    src/rotate.rs:87-97), |R₋(o−offset) − c| = |o − (R₊c + offset)|, so a
    transformed sphere is just a sphere at c' = R₊c + offset. For rects the
    object-space plane/axis unit vectors map to world frame vectors R₊e.
    """
    dtype = scene.prim_data.dtype
    ptype = scene.prim_type
    data = scene.prim_data
    xf = scene.prim_xform
    off = scene.xf_offset[xf]

    is_moving = ptype == PRIM_MOVING_SPHERE
    is_sphere = (ptype == PRIM_SPHERE) | is_moving
    is_rect = ptype == PRIM_RECT

    c0w = rot_plus(scene, xf, data[:, 0:3]) + off
    dc_obj = jnp.where(is_moving[:, None], data[:, 4:7] - data[:, 0:3], 0.0)
    dcw = rot_plus(scene, xf, dc_obj)
    mt0 = data[:, 7]
    mdt = data[:, 8] - data[:, 7]
    inv_dt = jnp.where(is_moving, 1.0 / jnp.where(mdt == 0, 1.0, mdt), 0.0)
    radius = data[:, 3]

    ek = _onehot3(scene.prim_axis, dtype)
    ea = _onehot3((scene.prim_axis + 1) % 3, dtype)
    eb = _onehot3((scene.prim_axis + 2) % 3, dtype)
    kn = rot_plus(scene, xf, ek)
    an = rot_plus(scene, xf, ea)
    bn = rot_plus(scene, xf, eb)

    return PrimPack(
        is_sphere=is_sphere, is_moving=is_moving, is_rect=is_rect,
        c0=c0w, dc=dcw, t0=mt0, inv_dt=inv_dt,
        radius=radius, r2=radius * radius,
        kn=kn, an=an, bn=bn,
        k_off=data[:, 4] + jnp.sum(off * kn, -1),
        a_off=jnp.sum(off * an, -1),
        b_off=jnp.sum(off * bn, -1),
        a0=data[:, 0], a1=data[:, 2], b0=data[:, 1], b1=data[:, 3],
    )


def _chunk_size(n: int, p: int, budget_elems: int = 1 << 25) -> int:
    """Pick the prim-chunk width: cover P in one pass when it fits the
    [N, C] temp budget (~128 MB of f32), else split."""
    c = max(8, budget_elems // max(n, 1))
    if c >= p:
        return p
    nchunks = -(-p // c)
    return -(-p // nchunks)  # even chunks covering p


def _candidate_ts(pack: PrimPack, o, d, time, t_min, t_max):
    """Candidate hit t for every (ray, prim) pair → [N, C] (BIG = miss).

    All [N, C] terms factor through [N,3] @ [3,C]-shaped reductions.
    """
    # ---- spheres (reference src/sphere.rs:37-77) ----
    # center'(time) = c0 + frac·dc, frac = (time−t0)·inv_dt (src/sphere.rs:115-118)
    # NOTE: oc is formed by subtraction FIRST (difference-first is numerically
    # stable near tangency; the expanded |o|²−2o·c'+|c'|² form cancels
    # catastrophically in f32). The broadcasted [N,C,3] terms fuse into the
    # [N,C] reductions — they never materialize.
    frac = (time[:, None] - pack.t0[None, :]) * pack.inv_dt[None, :]
    cprime = pack.c0[None, :, :] + frac[..., None] * pack.dc[None, :, :]
    oc = o[:, None, :] - cprime
    a = jnp.sum(d * d, -1)[:, None]
    b = jnp.sum(oc * d[:, None, :], -1)
    cc = jnp.sum(oc * oc, -1) - pack.r2[None, :]
    disc = b * b - a * cc
    # double-where keeps sqrt's cotangent finite on miss lanes (sqrt'(0)=inf
    # would otherwise turn into NaN·0 in reverse mode)
    pos = disc > 0.0
    sq = jnp.sqrt(jnp.where(pos, disc, 1.0))
    t_near = (-b - sq) / a
    t_far = (-b + sq) / a
    near_ok = pos & (t_near > t_min) & (t_near < t_max)
    far_ok = pos & (t_far > t_min) & (t_far < t_max)
    t_sph = jnp.where(near_ok, t_near, jnp.where(far_ok, t_far, BIG))

    # ---- rects (reference src/rect.rs:39-69) ----
    # plane: (o−off)·kn + t·(d·kn) = k  ⇔  o·kn + t·d·kn = k_off
    o_kn = _mm(o, pack.kn.T)
    d_kn = _mm(d, pack.kn.T)
    parallel = d_kn == 0.0
    t_r = (pack.k_off[None, :] - o_kn) / jnp.where(parallel, 1.0, d_kn)
    x = _mm(o, pack.an.T) + t_r * _mm(d, pack.an.T) - pack.a_off[None, :]
    y = _mm(o, pack.bn.T) + t_r * _mm(d, pack.bn.T) - pack.b_off[None, :]
    ok = (~parallel) & (t_r > t_min) & (t_r < t_max) \
        & (x >= pack.a0[None, :]) & (x <= pack.a1[None, :]) \
        & (y >= pack.b0[None, :]) & (y <= pack.b1[None, :])
    t_rect = jnp.where(ok, t_r, BIG)

    return jnp.where(pack.is_sphere[None, :], t_sph,
                     jnp.where(pack.is_rect[None, :], t_rect, BIG))


@jax.tree_util.register_dataclass
@dataclass
class Hit:
    t: jax.Array       # f32[N]  (BIG on miss)
    idx: jax.Array     # int32[N] winning primitive (-1 on miss)
    mask: jax.Array    # bool[N]


def closest_hit(scene: SceneTables, o, d, time, t_min: float,
                t_max: float = BIG, pack: PrimPack | None = None,
                chunk: int | None = None) -> Hit:
    """Closest surface hit over all primitives (min-reduction — order-free
    equivalent of the reference's shrinking scan, src/hittable.rs:37-47)."""
    if pack is None:
        pack = pack_prims(scene)
    n = o.shape[0]
    P = scene.num_prims
    chunk = chunk or _chunk_size(n, P)
    pad = (-P) % chunk
    nchunks = (P + pad) // chunk

    if nchunks == 1:
        # no padding needed — evaluate all P prims in one pass
        t = _candidate_ts(pack, o, d, time, t_min, t_max)
        t_best = jnp.min(t, axis=1)
        i_best = jnp.argmin(t, axis=1).astype(jnp.int32)
    else:
        def pad0(x):
            widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
            return jnp.pad(x, widths).reshape(nchunks, chunk, *x.shape[1:])

        packs = jax.tree.map(pad0, pack)
        live = (jnp.arange(nchunks * chunk, dtype=jnp.int32) < P).reshape(
            nchunks, chunk)

        def body(carry, xs):
            t_best, i_best, base = carry
            cpack, clive = xs
            t = _candidate_ts(cpack, o, d, time, t_min, t_max)
            t = jnp.where(clive[None, :], t, BIG)
            tc = jnp.min(t, axis=1)
            ic = jnp.argmin(t, axis=1).astype(jnp.int32) + base
            better = tc < t_best
            return (jnp.where(better, tc, t_best),
                    jnp.where(better, ic, i_best), base + chunk), None

        init = (jnp.full((n,), BIG, o.dtype), jnp.zeros((n,), jnp.int32),
                jnp.asarray(0, jnp.int32))
        (t_best, i_best, _), _ = jax.lax.scan(body, init, (packs, live))

    mask = t_best < BIG
    return Hit(t=t_best, idx=jnp.where(mask, i_best, -1), mask=mask)


def hit_attributes(scene: SceneTables, o, d, time, hit: Hit,
                   pack: PrimPack | None = None):
    """Attributes of each ray's winning primitive → (p, normal, u, v, mat_id).

    Normal/uv math matches reference src/sphere.rs:9-15,46-52 and
    src/rect.rs:53-60; instance rotation of the normal matches
    src/rotate.rs:100-112 (via the world-frame vectors in PrimPack). UVs are
    computed from object-space quantities exactly like the reference (which
    computes them inside the wrapped Hittable before un-rotating). Sphere v
    uses the canonical (θ+π/2)/π — the reference's FRAC_2_PI at
    src/sphere.rs:13 is a documented bug (SURVEY.md §7 quirk (a)).
    """
    if pack is None:
        pack = pack_prims(scene)
    idx = jnp.maximum(hit.idx, 0)
    g = lambda x: x[idx]
    # double-where discipline: miss lanes carry t = BIG, and BIG·d
    # overflows to inf for |d| > ~1.13 (camera directions are
    # UNNORMALIZED, |d| ~ 10). The forward pass masks the junk, but in
    # reverse mode a 0-cotangent times a NaN from a downstream
    # texture transcendental (marble's sin at p = inf) is NaN, and it
    # flows unmasked through p into o/d and every upstream parameter —
    # one escaping ray poisons the whole gradient pytree.
    t = jnp.where(hit.t < BIG, hit.t, 0.0)
    p = o + t[:, None] * d

    # sphere: world normal = (p − c'(time)) / r. Identical to the reference's
    # rotated-back object normal since (p_obj − c)/r maps by R₊.
    frac = (time - g(pack.t0)) * g(pack.inv_dt)
    center = g(pack.c0) + frac[:, None] * g(pack.dc)
    r_safe = g(pack.radius)
    r_safe = jnp.where(r_safe == 0.0, 1.0, r_safe)  # miss lanes gather slot 0
    n_sph = (p - center) / r_safe[:, None]

    # sphere uv needs the OBJECT-space normal (reference computes uv before
    # un-rotating, src/sphere.rs:46-52): n_obj = R₋ n_world.
    xf = scene.prim_xform[idx]
    if scene.has_xforms:
        n_obj = rot_minus(scene, xf, n_sph)
    else:
        n_obj = n_sph
    phi = jnp.arctan2(n_obj[:, 2], n_obj[:, 0])
    theta = jnp.arcsin(jnp.clip(n_obj[:, 1], -1.0, 1.0))
    u_sph = 1.0 - (phi + jnp.pi) / (2.0 * jnp.pi)
    # compat_uv_bug reproduces the reference's FRAC_2_PI constant
    # (src/sphere.rs:13) — see SceneTables.compat_uv_bug
    v_off = (2.0 / math.pi) if scene.compat_uv_bug else (math.pi / 2.0)
    v_sph = (theta + v_off) / jnp.pi

    # rect: u, v from world-frame projections (src/rect.rs:53-60)
    an, bn, kn = g(pack.an), g(pack.bn), g(pack.kn)
    x = jnp.sum(p * an, -1) - g(pack.a_off)
    y = jnp.sum(p * bn, -1) - g(pack.b_off)
    u_rect = (x - g(pack.a0)) / (g(pack.a1) - g(pack.a0))
    v_rect = (y - g(pack.b0)) / (g(pack.b1) - g(pack.b0))

    is_sph = g(pack.is_sphere)
    normal = jnp.where(is_sph[:, None], n_sph, kn)
    normal = normal * scene.prim_flip[idx][:, None]
    u = jnp.where(is_sph, u_sph, u_rect)
    v = jnp.where(is_sph, v_sph, v_rect)
    return p, normal, u, v, scene.prim_material[idx]


def media_scatter(scene: SceneTables, o, d, t_min: float,
                  t_surface: jnp.ndarray, u_med: jnp.ndarray):
    """Closed-form ConstantMedium sampling (reference src/medium.rs:28-56).

    Medium boundaries are STATIC (SceneBuilder gates ConstantMedium to
    sphere/box boundaries without motion) — no `time` parameter, by
    contract, so a future moving-boundary caller fails loudly instead of
    silently getting time-frozen media.

    For each medium: entry/exit of the ray *line* against the convex boundary
    (sphere roots, or box slab — equivalent to the reference's two
    boundary.hit calls over (−MAX, MAX)), clamp entry to t_min and exit to
    the closest surface t, then exponential free flight `−(1/ρ)·ln(U)`
    (src/medium.rs:40). Returns (t_scatter[N] (BIG if none), med_material[N]).

    u_med: [N, M] uniforms — one independent draw per medium per bounce,
    statistically identical to the reference's per-hit thread_rng draw.
    M is tiny (≤2 in every reference scene) so [N, M, 3] temps are fine here.
    """
    dtype = o.dtype
    xf = scene.med_xform
    off = scene.xf_offset[xf]
    d_norm = jnp.linalg.norm(d, axis=-1)

    # world→object: o' = R₋(o − off), d' = R₋ d (broadcast over media)
    o_obj = rot_minus(scene, xf[None, :], o[:, None, :] - off[None, :, :])
    d_obj = rot_minus(scene, xf[None, :], jnp.broadcast_to(
        d[:, None, :], (d.shape[0], xf.shape[0], 3)))

    data = scene.med_data  # [M, 6]

    # sphere boundary: both quadratic roots on the unbounded line
    oc = o_obj - data[None, :, 0:3]
    a = jnp.sum(d_obj * d_obj, -1)
    b = jnp.sum(oc * d_obj, -1)
    c = jnp.sum(oc * oc, -1) - (data[:, 3] * data[:, 3])[None]
    disc = b * b - a * c
    sph_ok = disc > 0.0
    sq = jnp.sqrt(jnp.where(sph_ok, disc, 1.0))  # see double-where note above
    sph_enter = (-b - sq) / a
    sph_exit = (-b + sq) / a

    # box boundary: slab test on the infinite line (tiny-denominator guard
    # keeps parallel-slab math finite: ±~1e33 in f32, no NaNs in gradients)
    pmin = data[None, :, 0:3]
    pmax = data[None, :, 3:6]
    d_safe = jnp.where(jnp.abs(d_obj) < 1e-30, 1e-30, d_obj)
    inv_d = 1.0 / d_safe
    t0 = (pmin - o_obj) * inv_d
    t1 = (pmax - o_obj) * inv_d
    lo = jnp.minimum(t0, t1)
    hi = jnp.maximum(t0, t1)
    box_enter = jnp.max(lo, axis=-1)
    box_exit = jnp.min(hi, axis=-1)
    box_ok = box_enter < box_exit

    is_sph = (scene.med_type == MED_SPHERE)[None]
    enter = jnp.where(is_sph, sph_enter, box_enter)
    exit_ = jnp.where(is_sph, sph_exit, box_exit)
    ok = jnp.where(is_sph, sph_ok, box_ok)

    # clamp to [t_min, t_surface] (reference src/medium.rs:32-37)
    enter = jnp.maximum(enter, t_min)
    exit_ = jnp.minimum(exit_, t_surface[:, None])
    ok = ok & (enter < exit_)

    dist_inside = (exit_ - enter) * d_norm[:, None]
    hit_dist = -(1.0 / scene.med_density)[None] * jnp.log(
        jnp.maximum(u_med, jnp.asarray(1e-37, dtype)))
    scatters = ok & (hit_dist < dist_inside)
    t_sc = jnp.where(scatters, enter + hit_dist / d_norm[:, None], BIG)

    best = jnp.argmin(t_sc, axis=-1)
    t_best = jnp.min(t_sc, axis=-1)
    return t_best, scene.med_material[best]
