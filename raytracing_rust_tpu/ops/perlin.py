"""Batched Perlin noise (reference src/perlin.rs) — hash-gradient form.

The reference builds 256 random unit gradient vectors plus three Fisher-Yates
permutation tables at texture construction (src/perlin.rs:12-26, :28-36) and
evaluates Hermite-smoothed trilinear gradient interpolation per point
(src/perlin.rs:38-97) and a 7-octave turbulence sum (src/perlin.rs:99-109).

Redesign — the tables are replaced by an arithmetic lattice hash:

* the reference's tables come from an UNSEEDED thread RNG (src/perlin.rs:5,13)
  — every run gets a different noise field, so there is no fixed pattern to
  match, only a distribution. We therefore derive each lattice corner's
  gradient from a murmur-style uint32 hash of (i & 255, j & 255, k & 255,
  seed): two hash uniforms parameterize a uniformly-distributed unit vector
  (cosθ = 2u₁−1, φ = 2πu₂) — the same gradient distribution as the
  reference's `random unit vectors`, with the same 256-periodic tiling as
  its `& 255` index wrap, but deterministic per seed and computable with
  pure per-lane arithmetic. No tables means no gathers and no table
  operands, so the GPU kernel evaluates noise in-kernel with the same
  code the XLA tier runs.
* lattice coordinates use a true signed floor. The reference's
  `floor(p) as usize` saturates negative coordinates to 0 (degenerate noise
  for p < 0); we use the canonical signed wrap for all coordinates.

The interpolation (Hermite weights, gradient dot products, octave sum) is
unchanged from the reference. `tests/oracle.py::perlin_noise` is the scalar
f64 mirror of this exact formula; `ops/pallas_tracer.py` carries the
in-kernel copy (`_turb`). The three implementations share bit-identical
integer paths (uints throughout; float transcendentals may differ by ulps
per backend).
"""

from __future__ import annotations

import math

import jax

import jax.numpy as jnp

# hash constants (distinct large odd 32-bit multipliers; murmur3 finalizers)
HA, HB, HC = 0x8DA6B343, 0xD8163841, 0xCB1AB31F
HSEED = 0x27D4EB2F
HM1, HM2, HM3 = 0x9E3779B1, 0x85EBCA6B, 0xC2B2AE35
INV24 = 1.0 / (1 << 24)


def _gradient(ci, cj, ck, seed: int):
    """Unit gradient vector at integer lattice corner (ci, cj, ck) & 255.

    ci/cj/ck: int32 arrays with values already wrapped to [0, 255].
    Returns (gx, gy, gz) f32 arrays. Mirrors reference src/perlin.rs:12-26
    (random unit vectors) via two hash uniforms instead of stored tables.
    """
    u = jnp.uint32
    h = ((ci.astype(u) * u(HA)) ^ (cj.astype(u) * u(HB))
         ^ (ck.astype(u) * u(HC)) ^ u((seed * HSEED) & 0xFFFFFFFF))
    h = h ^ (h >> u(13))
    h = h * u(HM1)
    h = h ^ (h >> u(16))
    g = (h ^ u(HM2)) * u(HM3)
    g = g ^ (g >> u(16))
    f = jnp.float32
    u1 = (h >> u(8)).astype(jnp.int32).astype(f) * f(INV24)
    u2 = (g >> u(8)).astype(jnp.int32).astype(f) * f(INV24)
    cz = f(2.0) * u1 - f(1.0)
    sz = jnp.sqrt(jnp.maximum(f(0.0), f(1.0) - cz * cz))
    phi = f(2.0 * math.pi) * u2
    return sz * jnp.cos(phi), sz * jnp.sin(phi), cz


# the 8 lattice-cell corners as a trailing vector axis: one vectorized
# _gradient/dot/weight evaluation instead of 8 unrolled copies. Python-
# unrolled corners+octaves made the op graph so large that XLA's CPU
# backend took 20+ s to compile jax.grad(turb) alone — and minutes-to-
# never inside the rematerialized bounce scan of trace(differentiable=
# True) on noise scenes. Same math, ~8x fewer HLO nodes.
_DI = jnp.asarray([0, 0, 0, 0, 1, 1, 1, 1], jnp.int32)
_DJ = jnp.asarray([0, 0, 1, 1, 0, 0, 1, 1], jnp.int32)
_DK = jnp.asarray([0, 1, 0, 1, 0, 1, 0, 1], jnp.int32)


def noise(p: jnp.ndarray, seed: int = 0) -> jnp.ndarray:
    """Gradient noise for points p[..., 3] (reference src/perlin.rs:58-97)."""
    pf = jnp.floor(p)
    uvw = p - pf  # fractional part in [0,1)
    ijk = pf.astype(jnp.int32)

    # Hermite smoothing (reference src/perlin.rs:39-41)
    s = uvw * uvw * (3.0 - 2.0 * uvw)

    gx, gy, gz = _gradient((ijk[..., 0, None] + _DI) & 255,
                           (ijk[..., 1, None] + _DJ) & 255,
                           (ijk[..., 2, None] + _DK) & 255, seed)
    di = _DI.astype(p.dtype)
    dj = _DJ.astype(p.dtype)
    dk = _DK.astype(p.dtype)
    dot = (gx * (uvw[..., 0, None] - di) + gy * (uvw[..., 1, None] - dj)
           + gz * (uvw[..., 2, None] - dk))
    wu = di * s[..., 0, None] + (1 - di) * (1.0 - s[..., 0, None])
    wv = dj * s[..., 1, None] + (1 - dj) * (1.0 - s[..., 1, None])
    ww = dk * s[..., 2, None] + (1 - dk) * (1.0 - s[..., 2, None])
    return jnp.sum(wu * wv * ww * dot, axis=-1)


def turb(p: jnp.ndarray, depth: int = 7, seed: int = 0) -> jnp.ndarray:
    """Fractal turbulence |Σ 0.5^k noise(2^k p)| (reference src/perlin.rs:99-109).

    lax.scan over octaves: the body (one noise evaluation) compiles ONCE
    instead of `depth` times — see the corner-vectorization note above.
    """

    def body(carry, _):
        accum, weight, q = carry
        accum = accum + weight * noise(q, seed)
        return (accum, weight * 0.5, q * 2.0), None

    init = (jnp.zeros(p.shape[:-1], p.dtype), jnp.asarray(1.0, p.dtype), p)
    (accum, _, _), _ = jax.lax.scan(body, init, None, length=depth)
    return jnp.abs(accum)
