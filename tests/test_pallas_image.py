"""CPU-side checks of the GPU kernel's image-texture path.

The kernel fetches texels and winner attributes with direct per-lane
gathers from refs (`fetch_texel`, `tab_ref[w, col]`) and computes UVs and
texel indices with the same helpers it calls in-kernel (`sphere_uv`,
`rect_uv`, `texel_base`). Interpret-mode Pallas checks the gathers
exactly; the index math is checked against the XLA tier's
ops/textures.py and ops/intersect.py formulas.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl

from raytracing_rust_tpu.ops import pallas_tracer as pt


def _interpret_call(kern, out_shape, *args):
    return pl.pallas_call(kern, out_shape=out_shape, interpret=True)(*args)


def _random_normals(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_texel_index_clamps_like_xla_tier():
    """texel_base: nearest texel with v flipped and clamp-to-edge on the
    image's TRUE dims, inside a padded atlas (textures.py)."""
    rng = np.random.default_rng(3)
    u = rng.uniform(-0.1, 1.1, 512).astype(np.float32)
    v = rng.uniform(-0.1, 1.1, 512).astype(np.float32)
    img_id = rng.integers(0, 3, 512).astype(np.float32)
    h, w = 12.0, 20.0
    atlas_hw = (16, 32)
    got = np.asarray(pt.texel_base(jnp.asarray(u), jnp.asarray(v),
                                   jnp.asarray(img_id), jnp.full(512, h),
                                   jnp.full(512, w), atlas_hw))
    i = np.clip((u * w).astype(np.int32), 0, int(w) - 1)
    j = np.clip(((1.0 - v) * h).astype(np.int32), 0, int(h) - 1)
    want = ((img_id.astype(np.int32) * 16 + j) * 32 + i) * 3
    np.testing.assert_array_equal(got, want)


def test_rect_uv_matches_hit_attributes():
    """rect_uv on a rotated, translated rect equals ops/intersect.py
    hit_attributes' UV for the same hits."""
    from raytracing_rust_tpu.models.scene import SceneBuilder
    from raytracing_rust_tpu.ops.intersect import (closest_hit,
                                                   hit_attributes)
    b = SceneBuilder()
    xf = b.transform(offset=(0.3, 0.2, 1.0), rotate_axis="y",
                     angle_deg=35.0)
    b.rect("xy", -1.0, -0.5, 2.0, 1.5, 0.25,
           b.lambertian(b.solid(0.5, 0.5, 0.5)), xform=xf)
    scene = b.build()
    rng = np.random.default_rng(5)
    n = 256
    o = jnp.asarray(np.tile([0.0, 0.4, 6.0], (n, 1)).astype(np.float32))
    d = jnp.asarray(np.stack([rng.uniform(-0.2, 0.3, n),
                              rng.uniform(-0.15, 0.15, n),
                              -np.ones(n)], -1).astype(np.float32))
    hit = closest_hit(scene, o, d, jnp.zeros(n), 1e-3)
    assert bool(hit.mask.mean() > 0.5)
    p, _, u_x, v_x, _ = hit_attributes(scene, o, d, jnp.zeros(n), hit)
    tab = pt.build_scene_table(scene)[0]
    g = lambda col: jnp.full((n,), tab[0, col])
    u_k, v_k = pt.rect_uv(p[:, 0], p[:, 1], p[:, 2], g,
                          jnp.zeros(n, bool))
    m = np.asarray(hit.mask)
    np.testing.assert_allclose(np.asarray(u_k)[m], np.asarray(u_x)[m],
                               atol=2e-6)
    np.testing.assert_allclose(np.asarray(v_k)[m], np.asarray(v_x)[m],
                               atol=2e-6)


def test_image_fetch_exact_gather():
    """fetch_texel inside a kernel: three direct gathers per lane return
    the atlas values at base, base+1, base+2 exactly."""
    rng = np.random.default_rng(7)
    atlas = rng.uniform(0, 1, 3 * 4096).astype(np.float32)
    base = (rng.integers(0, 4096, pt.BLOCK) * 3).astype(np.int32)

    def kern(img_ref, base_ref, out_ref):
        r, g, b = pt.fetch_texel(img_ref, base_ref[...])
        out_ref[0, :] = r
        out_ref[1, :] = g
        out_ref[2, :] = b

    out = _interpret_call(kern, jax.ShapeDtypeStruct((3, pt.BLOCK),
                                                     jnp.float32),
                          jnp.asarray(atlas), jnp.asarray(base))
    want = np.stack([atlas[base], atlas[base + 1], atlas[base + 2]])
    np.testing.assert_array_equal(np.asarray(out), want)


def test_sphere_uv_texel_matches_xla_tier():
    """End-to-end UV → texel selection: sphere_uv + texel_base pick the
    same texel as the XLA tier's arctan2/arcsin path (ops/textures.py)
    for random unit normals, both UV conventions."""
    n = _random_normals(4096, 11)
    h, w = 512, 1024
    for compat in (False, True):
        uu, vv = pt.sphere_uv(jnp.asarray(n[:, 0]), jnp.asarray(n[:, 1]),
                              jnp.asarray(n[:, 2]), compat)
        base = np.asarray(pt.texel_base(uu, vv, jnp.zeros(4096),
                                        jnp.full(4096, float(h)),
                                        jnp.full(4096, float(w)), (h, w)))
        phi = np.arctan2(n[:, 2], n[:, 0])
        theta = np.arcsin(np.clip(n[:, 1], -1, 1))
        u_np = 1.0 - (phi + np.pi) / (2 * np.pi)
        v_off = 2.0 / math.pi if compat else math.pi / 2
        v_np = (theta + v_off) / np.pi
        i = np.clip((u_np * w).astype(np.int32), 0, w - 1)
        j = np.clip(((1.0 - v_np) * h).astype(np.int32), 0, h - 1)
        assert ((base // 3) == j * w + i).mean() > 0.999


def test_attr_gather_exact():
    """Winner-attribute resolution: tab_ref[w, col] per lane equals the
    table entry exactly for every column."""
    rng = np.random.default_rng(9)
    tab = rng.normal(size=(300, pt.NF)).astype(np.float32)
    w = rng.integers(0, 300, pt.BLOCK).astype(np.int32)
    cols = list(range(0, pt.NF, 5))

    def kern(tab_ref, w_ref, out_ref):
        ws = w_ref[...]
        for k, c in enumerate(cols):
            out_ref[k, :] = tab_ref[ws, c]

    out = _interpret_call(kern, jax.ShapeDtypeStruct((len(cols), pt.BLOCK),
                                                     jnp.float32),
                          jnp.asarray(tab), jnp.asarray(w))
    np.testing.assert_array_equal(np.asarray(out), tab[w][:, cols].T)
