"""Wavefront path-tracing integrator.

The reference integrator is a scalar recursion up to depth 50
(`color(ray, world, depth)`, reference src/color.rs:6-23):

    hit  → emitted + attenuation ⊙ color(scattered, depth+1)   [while depth<50]
    miss → background (live code: black; the book-1 sky gradient is the
           commented block at src/color.rs:18-20 — here a per-scene option)

On an accelerator the recursion becomes an iterative *wavefront*: a batch of N rays
carries (origin, direction, throughput, radiance, alive) through a bounce
loop. Two loop flavors:

* `lax.while_loop` for forward rendering — exits as soon as every lane dies
  (typical paths die in a handful of bounces, not 50);
* `lax.scan` with a rematerialized body for reverse-mode autodiff
  (`while_loop` is not reverse-differentiable).

Medium events compete with surface hits exactly like the reference's
HittableList scan does (closest wins; src/hittable.rs:37-47 + medium.rs:28-56).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..models.scene import SceneTables, BG_SKY
from . import rng
from .intersect import (BIG, closest_hit, hit_attributes, media_scatter,
                        pack_prims)
from .materials import emitted as mat_emitted
from .materials import scatter as mat_scatter

# Column layout of the per-bounce lane draw vector (_lane_draws): one
# fused draw per lane per bounce, purposes slice out of it
_U_SPHERE = slice(0, 3)   # scatter direction (3 uniforms)
_U_BRANCH = 3             # dielectric reflect/refract branch
_U_MEDIUM = 4             # media free-flight draws start here (num_media)
# Russian roulette, when enabled, is the final column

T_MIN = 1e-3  # ray epsilon, reference src/color.rs:7


def background(scene: SceneTables, d: jnp.ndarray) -> jnp.ndarray:
    """Miss radiance. BG_SKY is the book-1 gradient the reference keeps
    commented out (src/color.rs:18-20); BG_BLACK is its live behavior."""
    if scene.background == BG_SKY:
        unit = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        t = 0.5 * (unit[:, 1] + 1.0)
        white = jnp.asarray([1.0, 1.0, 1.0], d.dtype)
        blue = jnp.asarray([0.5, 0.7, 1.0], d.dtype)
        return (1.0 - t)[:, None] * white + t[:, None] * blue
    return jnp.zeros_like(d)


def _lane_draws(scene, key, b, n, dtype, lane, rr: bool):
    """ALL of one bounce's U[0,1) draws, addressed by LANE id
    (rng.lane_uniforms) → [n, 4 + num_media? + rr?] (columns: _U_*).
    lane=None means the batch IS the full wavefront: lane i = row i.
    Every bounce draw goes through here, so a lane's stream follows its
    identity wherever compaction or sharding moves it — compacted
    renders are bit-identical to full-width ones, and a shard only pays
    for the lanes it holds."""
    m = 4 + (scene.num_media if scene.has_media else 0) + (1 if rr else 0)
    if lane is None:
        lane = jnp.arange(n, dtype=jnp.int32)
    return rng.lane_uniforms(key, b, lane, m, dtype)


def _bounce(scene: SceneTables, pack, key, max_depth, b, o, d, time, thr,
            rad, alive, bvh=None, rr_depth=None, lane=None):
    """One wavefront bounce; returns updated (o, d, thr, rad, alive).

    lane: see _lane_draws — set when (o, d, ...) is a compacted subset or
    shard of a wider wavefront and draws must follow lane identity.
    """
    n = o.shape[0]
    u_all = _lane_draws(scene, key, b, n, o.dtype, lane,
                        rr_depth is not None)
    if bvh is not None:
        from ..accel.bvh import bvh_closest_hit
        hit = bvh_closest_hit(scene, bvh, o, d, time, T_MIN, pack=pack)
    else:
        hit = closest_hit(scene, o, d, time, T_MIN, pack=pack)

    t_ev = hit.t
    med_mat = None
    if scene.has_media:
        u_med = u_all[:, _U_MEDIUM:_U_MEDIUM + scene.num_media]
        t_med, med_mat = media_scatter(scene, o, d, T_MIN, hit.t, u_med)
        med_event = t_med < hit.t
        t_ev = jnp.where(med_event, t_med, hit.t)

    hit_any = t_ev < BIG

    p, normal, u, v, mat_id = hit_attributes(scene, o, d, time, hit, pack=pack)
    if scene.has_media:
        p = jnp.where(med_event[:, None], o + t_med[:, None] * d, p)
        # arbitrary medium-hit attributes (reference src/medium.rs:44-50)
        normal = jnp.where(med_event[:, None],
                           jnp.asarray([1.0, 0.0, 0.0], o.dtype), normal)
        u = jnp.where(med_event, 0.0, u)
        v = jnp.where(med_event, 0.0, v)
        mat_id = jnp.where(med_event, med_mat, mat_id)

    # emitted light is added on every hit (reference src/color.rs:8-15)
    e = mat_emitted(scene, mat_id, u, v, p)
    rad = rad + jnp.where((alive & hit_any)[:, None], thr * e,
                          jnp.zeros_like(e))

    # misses collect the background and die (src/color.rs:16-22)
    bg = background(scene, d)
    rad = rad + jnp.where((alive & ~hit_any)[:, None], thr * bg,
                          jnp.zeros_like(bg))

    u_sphere = u_all[:, _U_SPHERE]
    u_branch = u_all[:, _U_BRANCH]
    new_d, att, ok = mat_scatter(scene, d, p, normal, u, v, mat_id,
                                 u_sphere, u_branch)

    # scatter allowed only below the depth cap (src/color.rs:9 `depth < 50`)
    cont = alive & hit_any & ok & (b < max_depth)
    thr = jnp.where(cont[:, None], thr * att, thr)

    if rr_depth is not None:
        # Russian roulette (NOT in the reference; opt-in, unbiased):
        # beyond rr_depth bounces, survive with p = max channel of the
        # throughput and compensate survivors by 1/p.
        u_rr = u_all[:, -1]
        # stop_gradient: the survival decision is a detached discrete
        # choice (like hit selection); differentiating through q(theta)
        # would leave an uncancelled -f*q'/q term in reverse mode
        q = jax.lax.stop_gradient(
            jnp.clip(jnp.max(thr, axis=-1), 0.05, 1.0))
        roulette = b >= rr_depth
        survive = (~roulette) | (u_rr < q)
        thr = jnp.where((cont & roulette & survive)[:, None],
                        thr / q[:, None], thr)
        cont = cont & survive

    o = jnp.where(cont[:, None], p, o)
    d = jnp.where(cont[:, None], new_d, d)
    return o, d, thr, rad, cont


@partial(jax.jit, static_argnames=("max_depth", "differentiable",
                                   "rr_depth"))
def trace(scene: SceneTables, o, d, time, key, max_depth: int = 50,
          differentiable: bool = False, bvh=None,
          rr_depth: int | None = None) -> jnp.ndarray:
    """Trace a batch of rays to completion → radiance [N, 3].

    o, d, time: ray batch (directions unnormalized, reference convention);
    key: RNG key for this batch (bounce/purpose folded in internally);
    bvh: optional FlatBVH — closest-hit goes through stacked traversal
    instead of the dense all-prims scan;
    rr_depth: optional bounce index to start Russian roulette (an opt-in
    unbiased estimator change — the reference always runs to the cap).
    """
    thr = jnp.ones_like(o)
    rad = jnp.zeros_like(o)
    alive = jnp.ones(o.shape[0], bool)
    pack = pack_prims(scene)  # transform hoisting: once per trace, not per bounce

    if differentiable:
        def body(carry, b):
            o, d, thr, rad, alive = carry
            o, d, thr, rad, alive = _bounce(scene, pack, key, max_depth, b,
                                            o, d, time, thr, rad, alive,
                                            bvh=bvh, rr_depth=rr_depth)
            return (o, d, thr, rad, alive), None

        body = jax.checkpoint(body)  # O(1) residual memory per bounce
        (_, _, _, rad, _), _ = jax.lax.scan(
            body, (o, d, thr, rad, alive), jnp.arange(max_depth + 1))
        return rad

    _, _, _, rad, _ = run_bounces(
        scene, pack, key, max_depth, 0, max_depth + 1, o, d, time, thr,
        rad, alive, bvh=bvh, rr_depth=rr_depth)
    return rad


def run_bounces(scene: SceneTables, pack, key, max_depth: int, b0, b_end,
                o, d, time, thr, rad, alive, bvh=None, rr_depth=None,
                lane=None):
    """Forward-mode bounce loop over b0 ≤ b < b_end (early exit when every
    lane dies) → (o, d, thr, rad, alive). The shared engine of `trace`
    (b0=0, b_end=max_depth+1) and the compacted wavefront segments in
    render.py (which gather the surviving lanes between segments and pass
    their original `lane` ids so the RNG streams follow the path, not the
    batch slot — see _lane_draws). b0/b_end may be traced scalars so every
    segment of a schedule shares one compiled program per batch width."""
    def cond(carry):
        b, _, _, _, _, alive = carry
        return (b < b_end) & jnp.any(alive)

    def body(carry):
        b, o, d, thr, rad, alive = carry
        o, d, thr, rad, alive = _bounce(scene, pack, key, max_depth, b,
                                        o, d, time, thr, rad, alive, bvh=bvh,
                                        rr_depth=rr_depth, lane=lane)
        return b + 1, o, d, thr, rad, alive

    _, o, d, thr, rad, alive = jax.lax.while_loop(
        cond, body, (jnp.asarray(b0, jnp.int32), o, d, thr, rad, alive))
    return o, d, thr, rad, alive
