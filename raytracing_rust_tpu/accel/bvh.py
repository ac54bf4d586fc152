"""Flat bounding-volume hierarchy — the XLA-tier answer to reference src/bvh.rs.

The reference builds a pointer tree of `Rc<dyn Hittable>` pairs (sort by
bbox.min along a thread_rng axis, median split, recurse; bvh.rs:17-66) and
traverses by recursing into BOTH children of any node whose AABB is hit
(bvh.rs:70-89). Neither pointers nor recursion exist under XLA, so:

* **Build** happens on the host (NumPy; optionally the C++ builder in
  `native/`) into flat SoA arrays: node AABBs, child indices, and a
  primitive permutation with leaf primitives contiguous. Median split like
  the reference, but the split axis is the largest centroid extent instead
  of `thread_rng().gen_range(0..3)` (bvh.rs:40) — deterministic builds are
  a design requirement (SURVEY.md §7 stance 4).

* **Per-primitive AABBs** fix the two latent reference bugs rather than
  reproduce them (SURVEY.md §7 stance 3): rect boxes respect the rect's
  plane (reference rect.rs:71-75 always builds XY), and rotated instances
  get a correct corner-expanded box (reference rotate.rs:36-37 initializes
  min/max swapped, yielding infinite boxes).

* **Traversal** is an explicit per-lane stack in a [N, DEPTH] array inside
  `lax.while_loop`: every iteration pops one node per lane, slab-tests it
  against the shrinking t_best, pushes both children on internal hits (the
  reference's unordered both-children descent) and brute-tests the ≤L
  contiguous primitives of leaf nodes. All node/prim state is gathered from
  the flat tables — no pointers, no recursion, fixed shapes.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import jax
import jax.numpy as jnp

from ..models.scene import (SceneTables, PRIM_MOVING_SPHERE,
                            PRIM_RECT)
from ..ops.intersect import Hit, PrimPack, pack_prims, BIG

LEAF_SIZE = 4
MAX_STACK = 48  # ≥ 2·tree depth; final_scene (~3.4k prims) needs ~24


@jax.tree_util.register_dataclass
@dataclass
class FlatBVH:
    node_min: jax.Array    # f32[Nn, 3]
    node_max: jax.Array    # f32[Nn, 3]
    node_left: jax.Array   # i32[Nn]  child id | first-prim slot (leaf)
    node_count: jax.Array  # i32[Nn]  0 = internal, else leaf prim count
    prim_order: jax.Array  # i32[ceil(P/L)*L] scene prim ids, -1 padding
    # the leaf width prim_order was padded with at build time; traversal
    # MUST test this many slots per leaf (a tree built with leaf_size=8
    # traversed at 4 silently skips half of every leaf's prims)
    leaf_size: int = field(metadata=dict(static=True), default=LEAF_SIZE)

    @property
    def num_nodes(self) -> int:
        return self.node_min.shape[0]


def prim_aabbs(scene: SceneTables) -> tuple[np.ndarray, np.ndarray]:
    """World-space AABB per primitive (host side, float64 NumPy).

    Sphere: center±r, motion-blur union over [t0,t1] exactly like
    reference sphere.rs:79-84 and :165-174. Rect: in-plane bounds padded
    ±1e-4 along the plane normal (the reference's rect.rs:71-75 modulo its
    plane bug), then corner-expanded through the instance rotation+offset
    (correct version of rotate.rs:36-58 + traslate.rs:26-32).
    """
    # ONE batched host pull instead of eight sequential device syncs
    (ptype, data, axis, xf, xf_axis, xf_sin, xf_cos,
     xf_off) = jax.device_get((scene.prim_type, scene.prim_data,
                               scene.prim_axis, scene.prim_xform,
                               scene.xf_axis, scene.xf_sin, scene.xf_cos,
                               scene.xf_offset))
    data = np.asarray(data, np.float64)
    xf_sin = np.asarray(xf_sin, np.float64)
    xf_cos = np.asarray(xf_cos, np.float64)
    xf_off = np.asarray(xf_off, np.float64)
    P = len(ptype)
    lo = np.empty((P, 3)); hi = np.empty((P, 3))
    for p in range(P):
        if ptype[p] == PRIM_RECT:
            a0, b0, a1, b1, k = data[p, :5]
            ka = int(axis[p]); aa = (ka + 1) % 3; bb = (ka + 2) % 3
            l = np.empty(3); h = np.empty(3)
            l[ka], h[ka] = k - 1e-4, k + 1e-4
            l[aa], h[aa] = a0, a1
            l[bb], h[bb] = b0, b1
        else:
            c0 = data[p, 0:3]; r = abs(data[p, 3])
            l = c0 - r; h = c0 + r
            if ptype[p] == PRIM_MOVING_SPHERE:
                c1 = data[p, 4:7]
                l = np.minimum(l, c1 - r); h = np.maximum(h, c1 + r)
        x = xf[p]
        if x != 0:
            # rotate all 8 corners by +θ then translate (object→world)
            ax = int(xf_axis[x]); s, c = xf_sin[x], xf_cos[x]
            a2, b2 = (ax + 1) % 3, (ax + 2) % 3
            cs = np.array(np.meshgrid(*[[l[i], h[i]] for i in range(3)],
                                      indexing="ij")).reshape(3, -1).T
            out = cs.copy()
            out[:, a2] = c * cs[:, a2] - s * cs[:, b2]
            out[:, b2] = s * cs[:, a2] + c * cs[:, b2]
            out += xf_off[x]
            l = out.min(axis=0); h = out.max(axis=0)
        lo[p] = l; hi[p] = h
    return lo, hi


def _outward_f32(nmin: np.ndarray, nmax: np.ndarray):
    """f64 node bounds → f32 rounded OUTWARD (min down, max up).

    A plain float cast rounds to nearest, which can pull a node box
    half an ulp INSIDE the true bound of its primitives; a ray that
    grazes a primitive within that sliver then misses the whole
    subtree. Invisible at reference scales, but measured at 100k prims
    (big_spheres): two pixels per 64x36 frame hit the wrong prim or
    nothing — one ulp of outward padding per cast removes the class.
    """
    lo32 = np.asarray(nmin, np.float32)
    hi32 = np.asarray(nmax, np.float32)
    lo32 = np.where(lo32.astype(np.float64) > np.asarray(nmin, np.float64),
                    np.nextafter(lo32, np.float32(-np.inf)), lo32)
    hi32 = np.where(hi32.astype(np.float64) < np.asarray(nmax, np.float64),
                    np.nextafter(hi32, np.float32(np.inf)), hi32)
    return lo32, hi32


def _check_stack_depth(left: np.ndarray, right: np.ndarray,
                       count: np.ndarray) -> None:
    """Build-time guard for the fixed traversal stack (the traversal
    clamps writes to MAX_STACK-1, so an over-deep tree would silently
    drop nodes — fail loudly on the host instead). Each pop pushes at
    most 2 children, so worst-case occupancy is depth + 1 entries."""
    depth = np.zeros(len(count), np.int32)
    todo = [0]
    maxd = 0
    while todo:
        nid = todo.pop()
        maxd = max(maxd, int(depth[nid]))
        if count[nid] == 0:  # internal
            for ch in (left[nid], right[nid]):
                depth[ch] = depth[nid] + 1
                todo.append(int(ch))
    if maxd + 2 > MAX_STACK:
        raise ValueError(
            f"BVH depth {maxd} needs a {maxd + 2}-slot traversal stack "
            f"but MAX_STACK={MAX_STACK}; raise MAX_STACK in accel/bvh.py")


def build_bvh(scene: SceneTables, leaf_size: int = LEAF_SIZE,
              prefer_native: bool = True) -> FlatBVH:
    """Median-split build over primitive bbox minima (reference
    bvh.rs:17-66 semantics, deterministic axis).

    Uses the C++ builder (native/rt_native.cpp — bit-identical algorithm)
    when the toolchain is available, NumPy otherwise.
    """
    lo, hi = prim_aabbs(scene)
    P = lo.shape[0]

    if prefer_native:
        from .. import native
        res = native.build_bvh_arrays(lo, hi, leaf_size)
        if res is not None:
            nmin, nmax, left, right, count, order = res
            _check_stack_depth(left, right, count)
            # the C++ builder already cast f64→f32 nearest; one ulp
            # outward is idempotent-safe (see _outward_f32)
            nmin = np.nextafter(nmin, np.float32(-np.inf))
            nmax = np.nextafter(nmax, np.float32(np.inf))
            return FlatBVH(
                node_min=jnp.asarray(nmin),
                node_max=jnp.asarray(nmax),
                node_left=jnp.asarray(
                    np.stack([left, right], 1).reshape(-1)),
                node_count=jnp.asarray(count),
                prim_order=jnp.asarray(order),
                leaf_size=leaf_size,
            )

    centroids = 0.5 * (lo + hi)

    node_min, node_max, node_left, node_count = [], [], [], []
    order: list[int] = []

    def emit(ids: np.ndarray) -> int:
        nid = len(node_min)
        node_min.append(lo[ids].min(axis=0))
        node_max.append(hi[ids].max(axis=0))
        node_left.append(0)
        node_count.append(0)
        if len(ids) <= leaf_size:
            node_left[nid] = len(order)
            node_count[nid] = len(ids)
            order.extend(int(i) for i in ids)
            # pad leaves to a fixed slot multiple for uniform gathers
            while len(order) % leaf_size:
                order.append(-1)
        else:
            ext = centroids[ids].max(axis=0) - centroids[ids].min(axis=0)
            ax = int(np.argmax(ext))
            ids = ids[np.argsort(lo[ids, ax], kind="stable")]
            mid = len(ids) // 2
            left = emit(ids[:mid])
            right = emit(ids[mid:])
            node_left[nid] = left
            rights.append((nid, right))
        return nid

    rights: list[tuple[int, int]] = []
    import sys
    rec = sys.getrecursionlimit()
    sys.setrecursionlimit(max(rec, 10000))
    try:
        emit(np.arange(P))
    finally:
        sys.setrecursionlimit(rec)

    Nn = len(node_min)
    right_arr = np.zeros(Nn, np.int32)
    for nid, r in rights:
        right_arr[nid] = r

    _check_stack_depth(np.asarray(node_left, np.int32), right_arr,
                       np.asarray(node_count, np.int32))
    nmin32, nmax32 = _outward_f32(np.asarray(node_min),
                                  np.asarray(node_max))
    return FlatBVH(
        node_min=jnp.asarray(nmin32),
        node_max=jnp.asarray(nmax32),
        node_left=jnp.asarray(
            np.stack([np.asarray(node_left, np.int32), right_arr], 1)
            .reshape(-1)),  # interleaved [left, right] pairs
        node_count=jnp.asarray(np.asarray(node_count, np.int32)),
        prim_order=jnp.asarray(np.asarray(order, np.int32)),
        leaf_size=leaf_size,
    )


def _slab(nmin, nmax, o, inv_d, t_min, t_max):
    """AABB slab test (reference aabb.rs:31-44), vectorized per lane."""
    t0 = (nmin - o) * inv_d
    t1 = (nmax - o) * inv_d
    lo = jnp.minimum(t0, t1)
    hi = jnp.maximum(t0, t1)
    enter = jnp.maximum(jnp.max(lo, axis=-1), t_min)
    leave = jnp.minimum(jnp.min(hi, axis=-1), t_max)
    return enter <= leave


def bvh_closest_hit(scene: SceneTables, bvh: FlatBVH, o, d, time,
                    t_min: float, pack: PrimPack | None = None,
                    leaf_size: int | None = None) -> Hit:
    """Closest hit via stacked BVH traversal → same Hit as closest_hit.

    leaf_size defaults to the width the tree was BUILT with (stored on
    FlatBVH) — a mismatch silently skips prims in every wider leaf."""
    if leaf_size is None:
        leaf_size = bvh.leaf_size
    if pack is None:
        pack = pack_prims(scene)
    n = o.shape[0]
    f = o.dtype
    d_safe = jnp.where(jnp.abs(d) < 1e-30, 1e-30, d)
    inv_d = 1.0 / d_safe

    stack = jnp.zeros((n, MAX_STACK), jnp.int32)
    sp = jnp.ones((n,), jnp.int32)          # stack holds root
    t_best = jnp.full((n,), BIG, f)
    i_best = jnp.full((n,), -1, jnp.int32)

    lr = bvh.node_left.reshape(-1, 2)

    # leaf prim pack rows gathered per (lane, slot)
    def leaf_test(first_slot, active, t_best, i_best):
        slots = first_slot[:, None] + jnp.arange(leaf_size)[None, :]
        pids = bvh.prim_order[slots]                    # [N, L]
        live = active[:, None] & (pids >= 0)
        pids = jnp.maximum(pids, 0)
        sub = jax.tree.map(lambda a: a[pids], pack)     # [N, L, ...] rows
        t = _leaf_candidates(sub, o, d, time, t_min, t_best)
        t = jnp.where(live, t, BIG)
        tc = jnp.min(t, axis=1)
        ic = jnp.take_along_axis(pids, jnp.argmin(t, 1)[:, None],
                                 1)[:, 0].astype(jnp.int32)
        better = tc < t_best
        return jnp.where(better, tc, t_best), jnp.where(better, ic, i_best)

    def cond(carry):
        sp = carry[1]
        return jnp.any(sp > 0)

    def body(carry):
        stack, sp, t_best, i_best = carry
        active = sp > 0
        top = jnp.maximum(sp - 1, 0)
        node = stack[jnp.arange(n), top]
        sp = jnp.where(active, sp - 1, sp)

        nmin = bvh.node_min[node]
        nmax = bvh.node_max[node]
        boxhit = active & _slab(nmin, nmax, o, inv_d, t_min, t_best)
        count = bvh.node_count[node]
        is_leaf = count > 0

        # leaf: test its prims
        t_best, i_best = leaf_test(lr[node, 0], boxhit & is_leaf,
                                   t_best, i_best)

        # internal: push both children (reference bvh.rs:74-85 descends
        # both unconditionally)
        push = boxhit & (~is_leaf)
        sp1 = jnp.where(push, sp + 1, sp)
        sp2 = jnp.where(push, sp + 2, sp)
        lane = jnp.arange(n)
        stack = stack.at[lane, jnp.minimum(sp, MAX_STACK - 1)].set(
            jnp.where(push, lr[node, 1], stack[lane, jnp.minimum(
                sp, MAX_STACK - 1)]))
        stack = stack.at[lane, jnp.minimum(sp1, MAX_STACK - 1)].set(
            jnp.where(push, lr[node, 0], stack[lane, jnp.minimum(
                sp1, MAX_STACK - 1)]))
        return stack, jnp.where(push, sp2, sp), t_best, i_best

    stack, sp, t_best, i_best = jax.lax.while_loop(
        cond, body, (stack, sp, t_best, i_best))
    mask = t_best < BIG
    return Hit(t=t_best, idx=jnp.where(mask, i_best, -1), mask=mask)


def _leaf_candidates(sub: PrimPack, o, d, time, t_min, t_max):
    """Candidate ts for per-lane gathered prim rows sub=[N, L] fields.

    Same math as ops.intersect._candidate_ts but with per-(lane, slot)
    primitive parameters instead of a shared [C] chunk.
    """
    f = o.dtype
    L = sub.radius.shape[1]
    oL = o[:, None, :]
    dL = d[:, None, :]

    # spheres
    frac = (time[:, None] - sub.t0) * sub.inv_dt
    cprime = sub.c0 + frac[..., None] * sub.dc
    oc = oL - cprime
    a = jnp.sum(d * d, -1)[:, None]
    b = jnp.sum(oc * dL, -1)
    cc = jnp.sum(oc * oc, -1) - sub.r2
    disc = b * b - a * cc
    pos = disc > 0.0
    sq = jnp.sqrt(jnp.where(pos, disc, 1.0))
    t_near = (-b - sq) / a
    t_far = (-b + sq) / a
    near_ok = pos & (t_near > t_min) & (t_near < t_max[:, None])
    far_ok = pos & (t_far > t_min) & (t_far < t_max[:, None])
    t_sph = jnp.where(near_ok, t_near, jnp.where(far_ok, t_far, BIG))

    # rects
    o_kn = jnp.sum(oL * sub.kn, -1)
    d_kn = jnp.sum(dL * sub.kn, -1)
    parallel = d_kn == 0.0
    t_r = (sub.k_off - o_kn) / jnp.where(parallel, 1.0, d_kn)
    x = jnp.sum(oL * sub.an, -1) + t_r * jnp.sum(dL * sub.an, -1) - sub.a_off
    y = jnp.sum(oL * sub.bn, -1) + t_r * jnp.sum(dL * sub.bn, -1) - sub.b_off
    ok = (~parallel) & (t_r > t_min) & (t_r < t_max[:, None]) \
        & (x >= sub.a0) & (x <= sub.a1) & (y >= sub.b0) & (y <= sub.b1)
    t_rect = jnp.where(ok, t_r, BIG)

    return jnp.where(sub.is_sphere, t_sph,
                     jnp.where(sub.is_rect, t_rect, BIG))
