"""The GPU forward kernel in Pallas interpret mode, and its random stream.

Interpret mode runs the same kernel body on the CPU (asked for
explicitly). At tiny sizes it must agree with the XLA tier in Monte Carlo
expectation (the two tiers draw from different streams), and its images
must not depend on how tiles and sample chunks are split, because every
draw is keyed on (seed, pixel, sample index, bounce, slot).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracing_rust_tpu.models import builders
from raytracing_rust_tpu.ops import pallas_tracer as pt
from raytracing_rust_tpu.render import render


def _linear_means(img):
    """Per-channel means of the gamma⁻¹ image (both tiers clip alike)."""
    return (img.astype(np.float64) ** 2).reshape(-1, 3).mean(axis=0)


@pytest.mark.parametrize("name,spp,depth,tol", [
    ("cornell_box", 256, 50, 0.04),   # lights, rotated boxes, black bg
    ("earth", 64, 12, 0.01),          # image texture, sky, lens + jitter
])
def test_interpret_matches_xla_tier(name, spp, depth, tol):
    p = builders.PRESETS[name]
    scene, cam = p.build(), p.camera()
    a = pt.render_pallas(scene, cam, 32, 32, spp, seed=1, max_depth=depth,
                         interpret=True)
    b = render(scene, cam, 32, 32, spp, seed=2, max_depth=depth)
    assert a.shape == b.shape == (32, 32, 3) and np.isfinite(a).all()
    np.testing.assert_allclose(_linear_means(a), _linear_means(b), rtol=tol)


def test_image_independent_of_device_split():
    """Same seed → bit-identical image on 1 and 3 devices (tiles move
    between devices; the draws follow the pixel)."""
    p = builders.PRESETS["two_spheres"]
    scene, cam = p.build(), p.camera()
    kw = dict(seed=4, max_depth=8, interpret=True)
    one = pt.render_pallas(scene, cam, 40, 24, 4,
                           devices=jax.devices("cpu")[:1], **kw)
    three = pt.render_pallas(scene, cam, 40, 24, 4,
                             devices=jax.devices("cpu")[:3], **kw)
    np.testing.assert_array_equal(one, three)


def test_image_independent_of_spp_chunking():
    """Sample chunks draw by absolute sample index: chunked and unchunked
    renders sum the same samples (only the f32/f64 summation order
    differs)."""
    p = builders.PRESETS["cornell_box"]
    scene, cam = p.build(), p.camera()
    kw = dict(seed=6, max_depth=10, interpret=True)
    whole = pt.render_pallas(scene, cam, 24, 24, 8, **kw)
    chunked = pt.render_pallas(scene, cam, 24, 24, 8, spp_chunk=2, **kw)
    np.testing.assert_allclose(chunked, whole, rtol=1e-5, atol=1e-6)
    other_seed = pt.render_pallas(scene, cam, 24, 24, 8, seed=7,
                                  max_depth=10, interpret=True)
    assert not np.array_equal(other_seed, whole)


def test_checkpoint_resume_byte_equal(tmp_path):
    """A render stopped after 2 of 4 chunks resumes from its .npz and
    finishes byte-equal to an uninterrupted run."""
    p = builders.PRESETS["cornell_box"]
    scene, cam = p.build(), p.camera()
    kw = dict(seed=4, max_depth=8, spp_chunk=2, interpret=True)
    ck = str(tmp_path / "ck.npz")
    full = pt.render_pallas(scene, cam, 16, 16, 8, **kw)
    pt.render_pallas(scene, cam, 16, 16, 8, checkpoint=ck,
                     _stop_after_chunks=2, **kw)
    assert os.path.exists(ck)
    assert int(np.load(ck)["done"]) == 4
    resumed = pt.render_pallas(scene, cam, 16, 16, 8, checkpoint=ck, **kw)
    np.testing.assert_array_equal(resumed, full)


def _draws(n_pix=256, n_samp=64, seed=3, bounce=2, slot=1):
    pix = jnp.arange(n_pix, dtype=jnp.int32)[:, None]
    samp = jnp.arange(n_samp, dtype=jnp.int32)[None, :]
    sk = pt.sample_key(pt.pixel_key(seed, pix), samp)
    return np.asarray(pt.draw(sk, jnp.full_like(samp, bounce), slot))


def test_rng_deterministic_and_in_range():
    a, b = _draws(), _draws()
    np.testing.assert_array_equal(a, b)
    assert a.dtype == np.float32
    assert (a >= 0.0).all() and (a < 1.0).all()
    assert not np.array_equal(a, _draws(seed=4))


def test_rng_uniformity():
    """64-bin chi-square and the first two moments of 2^16 draws."""
    u = _draws(n_pix=1024, n_samp=64).ravel()
    assert abs(u.mean() - 0.5) < 0.005
    assert abs(u.var() - 1.0 / 12.0) < 0.002
    counts = np.bincount((u * 64).astype(int), minlength=64)
    expect = u.size / 64
    chi2 = ((counts - expect) ** 2 / expect).sum()
    assert chi2 < 110.0   # 99.9% quantile of chi-square(63) is ~103


def test_rng_streams_independent():
    """Neighbouring pixels, samples, bounces and slots give uncorrelated
    draws (|r| < 0.02 at n = 2^16, 5 standard errors)."""
    base = _draws(n_pix=1024, n_samp=64)
    pairs = [
        (base[:-1], base[1:]),                              # pixel
        (base[:, :-1], base[:, 1:]),                        # sample
        (base, _draws(n_pix=1024, n_samp=64, bounce=3)),    # bounce
        (base, _draws(n_pix=1024, n_samp=64, slot=2)),      # slot
    ]
    for a, b in pairs:
        r = np.corrcoef(a.ravel(), b.ravel())[0, 1]
        assert abs(r) < 0.02, r


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_tier(gpu):
    """On a card: the compiled kernel (not interpret mode) against the XLA
    tier on the same device, in Monte Carlo expectation."""
    p = builders.PRESETS["cornell_box"]
    scene, cam = p.build(), p.camera()
    a = pt.render_pallas(scene, cam, 64, 64, 256, seed=1, devices=[gpu])
    b = render(scene, cam, 64, 64, 256, seed=2)
    np.testing.assert_allclose(_linear_means(a), _linear_means(b),
                               rtol=0.03)
