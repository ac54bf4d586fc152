"""CPU-side GPU-kernel tripwire: every kernel variant must LOWER for CUDA.

`jax.jit(f).trace(...).lower(lowering_platforms=("cuda",))` runs the
Pallas → Triton lowering on a host with no card. It fails on exactly the
class of error that only the card used to reveal: a primitive the
Triton route does not implement (`reduce_or` from `jnp.any`), value
slicing, a non-power-of-two load, or a plain trace-time Python error.
Every preset and every feature combination the kernel claims must lower;
the ones it does not claim must raise UnsupportedScene instead. ptxas,
registers and speed are the card's to judge (chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracing_rust_tpu.models import builders
from raytracing_rust_tpu.models.scene import SceneBuilder, BG_BLACK
from raytracing_rust_tpu.ops import pallas_tracer as pt

KERNEL_PRESETS = ["two_spheres", "cornell_box", "cornell_smoke",
                  "random_spheres", "two_perlin_spheres", "simple_light",
                  "earth", "final_scene"]
MEDIA_PRESETS = {"cornell_smoke", "final_scene"}


def _lower(scene, nx, ny, n_tiles, rr_depth=None):
    """Lower the forward kernel for CUDA → the lowered module's text."""
    tab, n_sph, feats, atlas, hw = pt.build_scene_table(scene)
    cam = np.zeros(pt.CAMREC, np.float32)
    params = np.asarray([0, 0, 4, 0], np.int32)
    f = lambda t, c, p, a: pt._trace_call(
        t, c, p, a, n_sph=n_sph, feats=feats, nx=nx, ny=ny, max_depth=50,
        rr_depth=rr_depth, perlin_seed=scene.perlin_seed, atlas_hw=hw,
        n_tiles=n_tiles)
    out = jax.eval_shape(f, tab, cam, params, atlas)
    assert out.shape == (3, n_tiles * pt.BLOCK)
    assert out.dtype == jnp.float32
    low = jax.jit(f).trace(tab, cam, params, atlas).lower(
        lowering_platforms=("cuda",))
    text = low.as_text()
    assert "rt_forward" in text
    return text


@pytest.mark.parametrize("name", KERNEL_PRESETS)
def test_kernel_traces(name):
    scene = builders.PRESETS[name].build()
    if name in MEDIA_PRESETS:
        with pytest.raises(pt.UnsupportedScene, match="media"):
            pt.build_scene_table(scene)
        return
    _lower(scene, nx=256, ny=128, n_tiles=4)


def test_kernel_traces_with_rr_and_multitile():
    # russian-roulette branch + several tiles + an image that is not a
    # multiple of BLOCK pixels
    _lower(builders.cornell_box(), nx=200, ny=200, n_tiles=5, rr_depth=6)


def test_kernel_traces_multipixel_banks():
    """A large table (3,000 spheres) runs through the same dynamic
    primitive loop and per-lane winner gathers as a small one."""
    _lower(builders.big_spheres(3000), nx=64, ny=64, n_tiles=2)


def test_kernel_traces_textured_dynamic_prims():
    """Checker, noise and image textures, metal and moving spheres mixed
    in one 120-sphere table: every texture gather and the moving-center
    lerp in both the loop and the winner resolve."""
    b = SceneBuilder()
    rng = np.random.default_rng(3)
    checker = b.lambertian(b.checker(b.solid(0.2, 0.3, 0.1),
                                     b.solid(0.9, 0.9, 0.9)))
    noise = b.lambertian(b.noise(2.0))
    img = b.lambertian(b.image(_texels()))
    metal = b.metal(b.solid(0.8, 0.7, 0.6), 0.2)
    for i in range(120):
        mat = (checker, noise, img, metal)[i % 4]
        c = rng.uniform(-10, 10, 3)
        if i % 7 == 0:
            b.moving_sphere(c, c + np.array([0.2, 0, 0]), 0.0, 1.0,
                            0.5, mat)
        else:
            b.sphere(tuple(c), 0.5, mat)
    scene = b.build()
    feats = pt.build_scene_table(scene)[2]
    assert {"checker", "noise", "image", "metal", "moving"} <= feats
    _lower(scene, nx=256, ny=128, n_tiles=4)


def _fake_trace_factory(calls):
    """Shape-faithful stand-in for _trace_call: each lane returns its own
    pixel id times the chunk's spp, so the host assembly is checkable."""
    def fake(tab, cam, params, atlas, *, n_sph, feats, nx, ny, max_depth,
             rr_depth, perlin_seed, atlas_hw, n_tiles, interpret=False):
        seed, s0, spp, tile0 = (int(x) for x in np.asarray(params))
        calls.append((s0, spp, tile0, n_tiles))
        pix = np.minimum((tile0 * pt.BLOCK
                          + np.arange(n_tiles * pt.BLOCK)), nx * ny - 1)
        v = pix.astype(np.float32) / (4.0 * nx * ny) * spp
        return jnp.asarray(np.broadcast_to(v, (3, v.size)))
    return fake


def test_render_pallas_host_path_cpu_interpret(monkeypatch):
    """render_pallas host logic — tile grid, device split, spp chunking,
    gamma — around a shape-faithful stub of the kernel."""
    calls = []
    monkeypatch.setattr(pt, "_trace_call", _fake_trace_factory(calls))
    scene = builders.two_spheres()
    cam = builders.PRESETS["two_spheres"].camera()
    img = pt.render_pallas(scene, cam, nx=160, ny=90, spp=8, spp_chunk=4,
                           devices=jax.devices("cpu")[:2])
    assert img.shape == (90, 160, 3)
    n_tiles = -(-160 * 90 // pt.BLOCK)
    # 2 chunks × 2 devices; chunks start at absolute sample 0 and 4
    assert sorted({c[0] for c in calls}) == [0, 4]
    assert sum(c[3] for c in calls) == 2 * n_tiles
    expect = np.sqrt(np.arange(160 * 90) / (4.0 * 160 * 90)).reshape(90, 160)
    np.testing.assert_allclose(img[..., 0], expect, atol=1e-6)


def test_block_mapping_assembly_bijection(monkeypatch):
    """Lane → pixel mapping and the host assembly are exact inverses over
    uneven device splits and a ragged last tile: every pixel receives
    exactly its own id back."""
    calls = []
    monkeypatch.setattr(pt, "_trace_call", _fake_trace_factory(calls))
    scene = builders.random_spheres()
    cam = builders.PRESETS["random_spheres"].camera()
    nx, ny = 200, 90
    img = pt.render_pallas(scene, cam, nx=nx, ny=ny, spp=1,
                           devices=jax.devices("cpu")[:3])
    assert len(calls) == 3 and calls[0][2] == 0
    assert [c[2] for c in calls] == sorted(c[2] for c in calls)
    expect = np.sqrt(np.arange(nx * ny, dtype=np.float32)
                     / (4.0 * nx * ny)).reshape(ny, nx)
    np.testing.assert_allclose(img[..., 2], expect, atol=1e-6)


def test_kernel_traces_earth_compat_uv():
    """The sphere-UV compat quirk (SceneTables.compat_uv_bug) is a static
    kernel variant — it must lower like any other."""
    scene = builders.earth(compat_uv_bug=True)
    assert "compat_uv" in pt.build_scene_table(scene)[2]
    _lower(scene, nx=256, ny=128, n_tiles=4)


# ---- feature-lattice corners ------------------------------------------------
# Legal reference scenes: DiffuseLight is texture-generic (reference
# src/material.rs:133-151), image textures go on any hittable
# (src/texture.rs:73-108). Each gets a synthetic scene that must build a
# table and lower; textured media are refused with the media reason.

def _texels(seed=3, h=8, w=16):
    rng = np.random.default_rng(seed)
    return (np.rint(rng.uniform(26, 230, (h, w, 3))).astype(np.float32)
            / 255.0).astype(np.float32)


def lattice_surfaces():
    """builders.lattice_scene's surfaces without its media."""
    b = SceneBuilder(background=BG_BLACK)
    b.sphere((0, -1000, 0), 1000.0, b.lambertian(b.solid(0.5, 0.5, 0.5)))
    b.rect("zx", -1, -1, 1, 1, 3.0,
           b.diffuse_light(b.checker(b.solid(4, 4, 4), b.solid(1, 1, 1))),
           flip=True)
    b.sphere((2, 1, 0), 0.5, b.diffuse_light(b.noise(3.0)))
    b.sphere((-2, 1, 0), 0.5, b.diffuse_light(b.image(_texels())))
    xf = b.transform(offset=(0, 0, 1), rotate_axis="y", angle_deg=45.0)
    b.rect("xy", -1, 0, 1, 2, -2.0, b.lambertian(b.image(_texels(4))),
           xform=xf)
    b.sphere((0, 1, 2), 0.8, b.lambertian(b.image(_texels(5))))
    b._pflip[-1] = -1.0
    xr = b.transform(rotate_axis="x", angle_deg=30.0)
    b.sphere((0, 3, 0), 0.6, b.lambertian(b.image(_texels(6))), xform=xr)
    return b.build()


def test_lattice_record_flags():
    tab, n_sph, feats, atlas, hw = pt.build_scene_table(lattice_surfaces())
    assert {"checker", "noise", "image", "light", "rot_uv"} <= feats
    assert (tab[:, pt.F_IMG] > 0).sum() == 4
    assert (tab[:, pt.F_NOISE] > 0).sum() == 1
    assert (tab[:, pt.F_CHK] > 0).sum() == 1
    # the flipped image sphere keeps its flip; the rotated one its R₋
    assert (tab[:, pt.F_FLIP] < 0).any()
    rot = tab[:, pt.F_ROT:pt.F_ROT + 9].reshape(-1, 3, 3)
    assert not np.allclose(rot, np.eye(3), atol=1e-6)
    np.testing.assert_allclose(rot @ rot.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), rot.shape),
                               atol=1e-6)
    with pytest.raises(pt.UnsupportedScene, match="media"):
        pt.build_scene_table(builders.lattice_scene())


def test_kernel_traces_lattice():
    _lower(lattice_surfaces(), nx=128, ny=128, n_tiles=2)


@pytest.mark.parametrize("hole", [
    "emissive_checker", "emissive_noise", "emissive_image",
    "image_rect", "image_flipped_sphere",
    "medium_checker", "medium_noise", "medium_image"])
def test_kernel_traces_each_former_hole(hole):
    b = SceneBuilder(background=BG_BLACK)
    white = b.lambertian(b.solid(0.5, 0.5, 0.5))
    b.sphere((0, -100, 0), 99.0, white)
    if hole == "emissive_checker":
        b.rect("zx", -1, -1, 1, 1, 3.0,
               b.diffuse_light(b.checker(b.solid(4, 4, 4),
                                         b.solid(1, 1, 1))), flip=True)
    elif hole == "emissive_noise":
        b.sphere((0, 2, 0), 0.5, b.diffuse_light(b.noise(3.0)))
    elif hole == "emissive_image":
        b.sphere((0, 2, 0), 0.5, b.diffuse_light(b.image(_texels())))
    elif hole == "image_rect":
        b.rect("xy", -1, 0, 1, 2, -2.0, b.lambertian(b.image(_texels())))
    elif hole == "image_flipped_sphere":
        b.sphere((0, 1, 0), 0.8, b.lambertian(b.image(_texels())))
        b._pflip[-1] = -1.0
    elif hole == "medium_checker":
        b.medium_sphere((0, 1, 0), 1.0, 0.5,
                        b.checker(b.solid(1, 0, 0), b.solid(0, 1, 0)))
    elif hole == "medium_noise":
        b.medium_box((-1, 0, -1), (1, 1, 1), 0.5, b.noise(2.0))
    elif hole == "medium_image":
        b.medium_sphere((0, 1, 0), 1.0, 0.5, b.image(_texels()))
    scene = b.build()
    if hole.startswith("medium"):
        with pytest.raises(pt.UnsupportedScene, match="media"):
            pt.build_scene_table(scene)
        return
    _lower(scene, nx=64, ny=64, n_tiles=1)


def test_kernel_traces_textured_medium_beside_image_sphere():
    """A checker-albedo medium beside an image sphere: the scene is
    refused as a whole (media), never rendered with the medium dropped."""
    b = SceneBuilder(background=BG_BLACK)
    b.sphere((0, -100, 0), 99.0, b.lambertian(b.solid(0.5, 0.5, 0.5)))
    b.sphere((0, 1.5, 0), 0.7, b.lambertian(b.image(_texels())))
    b.medium_sphere((0, 1, 0), 2.5, 0.3,
                    b.checker(b.solid(1, 0, 0), b.solid(0, 1, 0)))
    with pytest.raises(pt.UnsupportedScene, match="media"):
        pt.build_scene_table(b.build())


def test_remaining_holes_fall_back_exactly():
    """What the kernel does not cover raises UnsupportedScene (render_auto
    and the CLI then use the XLA tier, which handles all of it)."""
    # nested checker (reference src/texture.rs:27-48 is recursive)
    b = SceneBuilder()
    inner = b.checker(b.solid(1, 0, 0), b.solid(0, 1, 0))
    b.sphere((0, 0, 0), 1.0,
             b.lambertian(b.checker(inner, b.solid(1, 1, 1))))
    with pytest.raises(pt.UnsupportedScene, match="nested checker"):
        pt.build_scene_table(b.build())

    # isotropic material on a surface (only media scatter isotropically)
    b = SceneBuilder()
    b.sphere((0, 0, 0), 1.0, b.isotropic(b.solid(1, 1, 1)))
    with pytest.raises(pt.UnsupportedScene, match="material type"):
        pt.build_scene_table(b.build())


def test_rotated_image_rect_is_supported():
    b = SceneBuilder()
    xf = b.transform(offset=(0, 0, 1), rotate_axis="y", angle_deg=45.0)
    b.rect("xy", -1, -1, 1, 1, 0.0,
           b.lambertian(b.image(_texels())), xform=xf)
    _lower(b.build(), nx=64, ny=64, n_tiles=1)
