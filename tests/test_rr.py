"""Russian roulette (opt-in): unbiasedness + variance sanity (XLA tier;
the GPU kernel's RR branch is covered by tools/parity.py's cornell_box_rr)."""

import numpy as np
import jax
import jax.numpy as jnp

from raytracing_rust_tpu.models.scene import SceneBuilder, BG_BLACK
from raytracing_rust_tpu.ops.integrator import trace


def _enclosure():
    """High-albedo closed-ish box: long paths, so RR actually engages."""
    b = SceneBuilder(background=BG_BLACK)
    white = b.lambertian(b.solid(0.9, 0.9, 0.9))
    b.rect("zx", -5, -5, 5, 5, 0.0, white)           # floor (+y)
    b.rect("zx", -5, -5, 5, 5, 10.0, white, flip=True)  # ceiling (−y)
    b.rect("yz", 0, -5, 10, 5, -5.0, white)
    b.rect("yz", 0, -5, 10, 5, 5.0, white, flip=True)
    b.rect("xy", -5, 0, 5, 10, -5.0, white)
    b.rect("xy", -5, 0, 5, 10, 5.0, white, flip=True)
    b.rect("zx", -1, -1, 1, 1, 9.9, b.diffuse_light(b.solid(4, 4, 4)),
           flip=True)
    return b.build()


def _mean(scene, key, rr_depth, n=20000):
    o = jnp.tile(jnp.asarray([[0.0, 5.0, 0.0]]), (n, 1))
    rng = np.random.default_rng(3)
    d = jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)
    rad = trace(scene, o, d, jnp.zeros(n), key, max_depth=50,
                rr_depth=rr_depth)
    return np.asarray(rad).mean()


def test_rr_is_unbiased():
    scene = _enclosure()
    k1, k2 = jax.random.split(jax.random.key(0))
    full = _mean(scene, k1, rr_depth=None)
    rr = _mean(scene, k2, rr_depth=3)
    assert full > 0.05
    # same expectation; 6% band covers MC noise of two independent
    # 20k-path means plus the RR variance inflation
    np.testing.assert_allclose(rr, full, rtol=0.06)


def test_rr_at_cap_is_noop():
    """rr_depth == max_depth never rolls (cont is already false at the
    cap). The two variants compile to different XLA programs, so f32
    fusion differences leak ~1e-5 through grazing-ray chaos — compare
    tightly but not bitwise."""
    scene = _enclosure()
    key = jax.random.key(1)
    a = _mean(scene, key, rr_depth=None, n=2000)
    b = _mean(scene, key, rr_depth=50, n=2000)
    np.testing.assert_allclose(a, b, rtol=2e-3)
