"""FlatBVH build + traversal vs the dense closest-hit scan (reference
src/bvh.rs semantics; build is deterministic, traversal must agree exactly
with brute force)."""

import numpy as np
import jax.numpy as jnp

from raytracing_rust_tpu.accel.bvh import (build_bvh, bvh_closest_hit,
                                           prim_aabbs)
from raytracing_rust_tpu.models.scene import SceneBuilder
from raytracing_rust_tpu.models import builders
from raytracing_rust_tpu.ops.intersect import closest_hit

RT = np.random.default_rng(17)


def _random_scene(n_spheres=60, cubes=3, moving=4, xform=True):
    b = SceneBuilder()
    m = b.lambertian(b.solid(1, 1, 1))
    for _ in range(n_spheres):
        b.sphere(RT.normal(0, 5, 3), 0.2 + RT.random(), m)
    for _ in range(moving):
        c = RT.normal(0, 5, 3)
        b.moving_sphere(c, c + RT.normal(0, 0.5, 3), 0.0, 1.0, 0.5, m)
    for i in range(cubes):
        p0 = RT.normal(0, 4, 3)
        kw = {}
        if xform and i % 2:
            kw["xform"] = b.transform(offset=RT.normal(0, 2, 3),
                                      rotate_axis="y",
                                      angle_deg=float(RT.uniform(-90, 90)))
        b.cube(p0, p0 + RT.uniform(0.5, 2.0, 3), m, **kw)
    return b.build()


def _rays(n=256):
    o = RT.normal(0, 8, (n, 3))
    d = -o + RT.normal(0, 2, (n, 3))  # aim toward the cluster
    return (jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32),
            jnp.asarray(RT.random(n), jnp.float32))


def test_prim_aabbs_contain_hits():
    """Every brute-force hit point must lie inside its prim's AABB."""
    scene = _random_scene()
    lo, hi = prim_aabbs(scene)
    o, d, time = _rays()
    h = closest_hit(scene, o, d, time, 1e-3)
    t = np.asarray(h.t); idx = np.asarray(h.idx); mask = np.asarray(h.mask)
    # float64: miss lanes carry t=BIG, which overflows the f32 product
    p = np.asarray(o, np.float64) + t[:, None].astype(np.float64) \
        * np.asarray(d, np.float64)
    eps = 1e-2
    for i in np.nonzero(mask)[0]:
        assert np.all(p[i] >= lo[idx[i]] - eps), (i, idx[i])
        assert np.all(p[i] <= hi[idx[i]] + eps), (i, idx[i])


def test_bvh_matches_brute_force():
    scene = _random_scene()
    bvh = build_bvh(scene)
    o, d, time = _rays(512)
    brute = closest_hit(scene, o, d, time, 1e-3)
    fast = bvh_closest_hit(scene, bvh, o, d, time, 1e-3)
    np.testing.assert_array_equal(np.asarray(brute.mask),
                                  np.asarray(fast.mask))
    np.testing.assert_array_equal(np.asarray(brute.idx),
                                  np.asarray(fast.idx))
    # t differs only by f32 summation order (matmul vs gathered products)
    np.testing.assert_allclose(np.asarray(brute.t)[np.asarray(brute.mask)],
                               np.asarray(fast.t)[np.asarray(fast.mask)],
                               rtol=1e-4)


def test_bvh_structure():
    scene = _random_scene(n_spheres=33, cubes=0, moving=0)
    bvh = build_bvh(scene, leaf_size=4)
    order = np.asarray(bvh.prim_order)
    real = order[order >= 0]
    assert sorted(real.tolist()) == list(range(scene.num_prims))
    assert len(order) % 4 == 0
    counts = np.asarray(bvh.node_count)
    lr = np.asarray(bvh.node_left).reshape(-1, 2)
    # internal nodes' boxes contain their children's boxes
    nmin = np.asarray(bvh.node_min); nmax = np.asarray(bvh.node_max)
    for nid in np.nonzero(counts == 0)[0]:
        for ch in lr[nid]:
            assert np.all(nmin[nid] <= nmin[ch] + 1e-6)
            assert np.all(nmax[nid] >= nmax[ch] - 1e-6)


def test_bvh_on_random_spheres_preset():
    """The ~441-prim random_spheres scene (the reference's BVH scene,
    tests/test.rs:89-163) traverses correctly."""
    scene = builders.random_spheres()
    bvh = build_bvh(scene)
    o, d, time = _rays(128)
    brute = closest_hit(scene, o, d, time, 1e-3)
    fast = bvh_closest_hit(scene, bvh, o, d, time, 1e-3)
    np.testing.assert_array_equal(np.asarray(brute.idx), np.asarray(fast.idx))
    # f32 order-of-operations noise; grazing hits see ~1e-4 absolute
    np.testing.assert_allclose(np.asarray(brute.t), np.asarray(fast.t),
                               rtol=1e-3, atol=1e-4)


def test_bvh_leaf_size_is_stored_and_used():
    """Regression (round-3 review): a tree built with leaf_size=8 must
    traverse 8 slots per leaf — the old default-4 traversal silently
    skipped half of every leaf's prims (false misses)."""
    scene = builders.random_spheres()
    bvh8 = build_bvh(scene, leaf_size=8)
    assert bvh8.leaf_size == 8
    o, d, time = _rays(128)
    brute = closest_hit(scene, o, d, time, 1e-3)
    fast = bvh_closest_hit(scene, bvh8, o, d, time, 1e-3)
    np.testing.assert_array_equal(np.asarray(brute.idx), np.asarray(fast.idx))


def test_bvh_render_per_chunk_dispatch_matches_multi():
    """Regression (round-3 review): with use_bvh and n_chunks>1 the host
    now dispatches per chunk (stack-memory cap on block_pixels*spp_chunk, not
    block_pixels alone); key folding is identical, so the image must be
    bit-equal to the single-dispatch fori path at the same chunking."""
    from raytracing_rust_tpu.render import render
    scene = builders.two_spheres()
    cam = builders.PRESETS["two_spheres"].camera()
    a = render(scene, cam, 24, 16, 8, seed=3, spp_chunk=4, use_bvh=True)
    b = render(scene, cam, 24, 16, 8, seed=3, spp_chunk=4, use_bvh=False)
    # BVH vs dense scan find identical winners on this scene; any
    # chunk-key drift in the new per-chunk path would show here
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
