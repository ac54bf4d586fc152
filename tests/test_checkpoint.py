"""Resumable rendering: interrupted + resumed == uninterrupted."""

import os
import tempfile

import numpy as np

from raytracing_rust_tpu.models import builders
from raytracing_rust_tpu.render import render


def test_checkpoint_resume_bit_identical():
    preset = builders.PRESETS["two_spheres"]
    scene = preset.build()
    cam = preset.camera()
    kw = dict(nx=32, ny=32, spp=4, seed=5, max_depth=6, block_pixels=256)

    full = render(scene, cam, **kw)

    with tempfile.TemporaryDirectory() as td:
        ck = os.path.join(td, "render.npz")
        # "interrupt" after two blocks by rendering with a doctored copy:
        # run once fully to populate the checkpoint, then truncate it back
        render(scene, cam, checkpoint=ck, **kw)
        data = dict(np.load(ck))
        assert int(data["next_block"]) == 4  # 1024 px / 256
        # rewind to block 2: zero the later blocks' sums
        sums = data["sums"].copy()
        sums[2 * 256:] = 0.0
        np.savez(ck, meta=data["meta"], sums=sums, next_block=2)

        resumed = render(scene, cam, checkpoint=ck, **kw)
    np.testing.assert_array_equal(full, resumed)


def test_checkpoint_ignored_on_config_change():
    preset = builders.PRESETS["two_spheres"]
    scene = preset.build()
    cam = preset.camera()
    with tempfile.TemporaryDirectory() as td:
        ck = os.path.join(td, "render.npz")
        render(scene, cam, 32, 32, 4, seed=5, checkpoint=ck)
        a = render(scene, cam, 32, 32, 4, seed=6, checkpoint=ck)  # new seed
        b = render(scene, cam, 32, 32, 4, seed=6)
    np.testing.assert_array_equal(a, b)


def test_checkpoint_ignored_on_scene_or_camera_change():
    """A checkpoint written for one scene/camera must not seed another
    render whose explicit meta scalars happen to match (stale sums were
    once silently merged)."""
    preset = builders.PRESETS["two_spheres"]
    scene = preset.build()
    cam = preset.camera()
    other = builders.PRESETS["two_perlin_spheres"].build()
    with tempfile.TemporaryDirectory() as td:
        ck = os.path.join(td, "render.npz")
        render(scene, cam, 32, 32, 4, seed=5, checkpoint=ck)
        a = render(other, cam, 32, 32, 4, seed=5, checkpoint=ck)
        b = render(other, cam, 32, 32, 4, seed=5)
        np.testing.assert_array_equal(a, b)
        # camera change alone must also invalidate
        cam2 = builders.PRESETS["two_spheres"].camera()
        cam2 = type(cam2)(**{**cam2.__dict__, "lens_radius": 0.0})
        render(scene, cam, 32, 32, 4, seed=7, checkpoint=ck)
        c = render(scene, cam2, 32, 32, 4, seed=7, checkpoint=ck)
        d = render(scene, cam2, 32, 32, 4, seed=7)
        np.testing.assert_array_equal(c, d)


def test_digest_covers_static_flags():
    """Regression (round-3 review): static aux-data flags are not pytree
    leaves, so the digest must hash them explicitly — compat_uv_bug was
    missed and two earth renders differing only in the sphere-UV quirk
    would have merged checkpoints."""
    from raytracing_rust_tpu.render import _render_digest
    cam = builders.PRESETS["earth"].camera()
    a = _render_digest(builders.earth(compat_uv_bug=False), cam, False)
    b = _render_digest(builders.earth(compat_uv_bug=True), cam, False)
    assert a != b
