"""Texture + Perlin parity vs the scalar oracle (reference src/texture.rs,
src/perlin.rs)."""

import numpy as np
import jax.numpy as jnp

import oracle
from raytracing_rust_tpu.models.scene import SceneBuilder
from raytracing_rust_tpu.ops import perlin
from raytracing_rust_tpu.ops.textures import eval_texture

RT = np.random.default_rng(11)


def test_perlin_noise_vs_oracle():
    # include negative coords — canonical signed-floor behavior
    pts = RT.uniform(-20, 20, (64, 3))
    got = np.asarray(perlin.noise(jnp.asarray(pts, jnp.float32)))
    for i in range(64):
        want = oracle.perlin_noise(pts[i])
        np.testing.assert_allclose(got[i], want, rtol=1e-3, atol=2e-3)


def test_perlin_turb_vs_oracle():
    pts = RT.uniform(-4, 4, (16, 3))
    got = np.asarray(perlin.turb(jnp.asarray(pts, jnp.float32)))
    for i in range(16):
        want = oracle.perlin_turb(pts[i])
        # turbulence sums 7 octaves of f32 error at doubled frequencies
        np.testing.assert_allclose(got[i], want, rtol=2e-2, atol=2e-2)


def test_perlin_noise_range_and_smoothness():
    pts = RT.uniform(-50, 50, (512, 3)).astype(np.float32)
    vals = np.asarray(perlin.noise(jnp.asarray(pts)))
    assert np.all(np.abs(vals) <= 1.0)  # gradient noise bound
    assert vals.std() > 0.05            # not degenerate (negative coords live)


def test_perlin_seed_changes_field():
    pts = jnp.asarray(RT.uniform(-4, 4, (64, 3)), jnp.float32)
    a = np.asarray(perlin.noise(pts, seed=0))
    b = np.asarray(perlin.noise(pts, seed=1))
    assert np.abs(a - b).max() > 0.05  # different seed → different field
    c = np.asarray(perlin.noise(pts, seed=0))
    np.testing.assert_array_equal(a, c)  # deterministic per seed


def test_perlin_continuity_across_cells():
    """Gradient noise must be C0 across lattice-cell boundaries — a hash
    mistake (e.g. wrapping before vs after the +1 corner offset) breaks
    exactly this."""
    eps = 1e-4
    for edge in ([3.0, 1.3, 2.7], [255.9999, 0.5, 0.5], [-1.0, -2.0, -3.0]):
        lo = np.asarray([oracle.perlin_noise(np.asarray(edge) - eps)])
        hi = np.asarray([oracle.perlin_noise(np.asarray(edge) + eps)])
        np.testing.assert_allclose(lo, hi, atol=5e-3)


def _eval(scene, tex_id, u, v, p):
    n = len(u)
    return np.asarray(eval_texture(
        scene, jnp.full(n, tex_id, jnp.int32), jnp.asarray(u, jnp.float32),
        jnp.asarray(v, jnp.float32), jnp.asarray(p, jnp.float32)))


def test_solid_and_checker():
    b = SceneBuilder()
    odd = b.solid(0.2, 0.3, 0.1)
    even = b.solid(0.9, 0.9, 0.9)
    chk = b.checker(odd, even)
    b.sphere((0, 0, 0), 1.0, b.lambertian(chk))
    scene = b.build()
    pts = RT.uniform(-3, 3, (64, 3))
    got = _eval(scene, chk, np.zeros(64), np.zeros(64), pts)
    for i in range(64):
        want = oracle.checker_value([0.2, 0.3, 0.1], [0.9, 0.9, 0.9], pts[i])
        np.testing.assert_allclose(got[i], want, rtol=1e-6)


def test_noise_texture_marble():
    """0.5·(1+sin(scale·x + 5·turb(p))) (reference src/texture.rs:66-70)."""
    b = SceneBuilder()
    tex = b.noise(4.0)
    b.sphere((0, 0, 0), 1.0, b.lambertian(tex))
    scene = b.build()
    pts = RT.uniform(-2, 2, (32, 3))
    got = _eval(scene, tex, np.zeros(32), np.zeros(32), pts)
    for i in range(32):
        turb = oracle.perlin_turb(pts[i])
        want = 0.5 * (1.0 + np.sin(4.0 * pts[i][0] + 5.0 * turb))
        np.testing.assert_allclose(got[i], np.full(3, want), atol=0.05)
    assert np.all(got >= 0.0) and np.all(got <= 1.0)


def test_image_texture_vs_oracle():
    data = RT.random((8, 16, 3)).astype(np.float32)
    b = SceneBuilder()
    tex = b.image(data)
    b.sphere((0, 0, 0), 1.0, b.lambertian(tex))
    scene = b.build()
    u = RT.random(64)
    v = RT.random(64)
    got = _eval(scene, tex, u, v, np.zeros((64, 3)))
    for i in range(64):
        np.testing.assert_allclose(got[i], oracle.image_value(data, u[i], v[i]),
                                   rtol=1e-6)


def test_two_images_of_different_sizes():
    """Per-image true dims: the smaller image must never sample the zero
    padding of the shared atlas."""
    big = RT.random((8, 16, 3)).astype(np.float32)
    small = RT.random((4, 6, 3)).astype(np.float32)
    b = SceneBuilder()
    t_big = b.image(big)
    t_small = b.image(small)
    b.sphere((0, 0, 0), 1.0, b.lambertian(t_big))
    b.sphere((3, 0, 0), 1.0, b.lambertian(t_small))
    scene = b.build()
    u = RT.random(32)
    v = RT.random(32)
    got_b = _eval(scene, t_big, u, v, np.zeros((32, 3)))
    got_s = _eval(scene, t_small, u, v, np.zeros((32, 3)))
    for i in range(32):
        np.testing.assert_allclose(got_b[i], oracle.image_value(big, u[i], v[i]),
                                   rtol=1e-6)
        np.testing.assert_allclose(got_s[i], oracle.image_value(small, u[i], v[i]),
                                   rtol=1e-6)


def test_image_texture_clamps_to_edge():
    data = RT.random((8, 16, 3)).astype(np.float32)
    b = SceneBuilder()
    tex = b.image(data)
    b.sphere((0, 0, 0), 1.0, b.lambertian(tex))
    scene = b.build()
    got = _eval(scene, tex, np.array([-0.5, 1.5]), np.array([1.5, -0.5]),
                np.zeros((2, 3)))
    np.testing.assert_allclose(got[0], data[0, 0], rtol=1e-6)   # u<0,v>1
    np.testing.assert_allclose(got[1], data[-1, -1], rtol=1e-6)  # u>1,v<0


def test_turb_matches_native_mirror_pointwise():
    """ops/perlin.py's hash-gradient turbulence FIELD vs the C++ mirror's
    independent scalar f64 transcription (ref_tracer.cpp hash_perlin) at
    exact points — deterministic, no Monte Carlo floor. The e2e noise
    radiometry test (test_e2e_oracle.py simple_light) cannot distinguish
    two valid fields (identical half-mean statistics, measured); this
    pointwise check is what pins the lattice hash, gradient construction,
    and octave sum themselves. Measured agreement is f32-ulp scale
    (~4e-6); wrong-seed fields differ by ~0.14 mean — 5 orders above tol."""
    from raytracing_rust_tpu import native
    from raytracing_rust_tpu.ops import perlin
    import jax.numpy as jnp

    if native._load_ref() is None:  # pragma: no cover
        import pytest
        pytest.skip("native toolchain unavailable")

    pts = RT.uniform(-20.0, 20.0, (2048, 3))
    for seed in (0, 3):
        ref = native.ref_hash_turb(pts, depth=7, seed=seed)
        ours = np.asarray(perlin.turb(jnp.asarray(pts, jnp.float32),
                                      depth=7, seed=seed))
        assert np.abs(ours - ref).max() < 5e-5, (
            f"seed {seed}: max |err| {np.abs(ours - ref).max():.2e}")
