"""Large-scene scaling support.

big_spheres(n) is the parametric scale scene (reference src/bvh.rs:9-94
exists for exactly this regime); DESIGN.md "Large scenes" holds the
measured dense/BVH crossover table these tests pin the policy of."""

import jax
import numpy as np

from raytracing_rust_tpu.models.builders import (big_spheres,
                                                 big_spheres_camera)
from raytracing_rust_tpu.render import auto_use_bvh, render


def test_dense_and_bvh_agree_at_12k_prims():
    """>10k-prim scene renders correctly on both XLA paths (same seed →
    same draws; means must agree tightly). Tolerance is NOT zero: at
    large coordinate scales the dense f32 quadratic's b²−a·c loses
    ~half its bits and near-tangency rays become coin flips the BVH's
    exact AABB prefilter resolves differently (DESIGN.md "Large
    scenes" — measured 2 px / 2304 at 100k prims; none at 30k)."""
    n = 12000
    scene = big_spheres(n)
    assert scene.num_prims >= 12000
    cam = big_spheres_camera(n, 48, 27)
    a = render(scene, cam, 48, 27, 2, max_depth=6, use_bvh=False)
    b = render(scene, cam, 48, 27, 2, max_depth=6, use_bvh=True)
    assert np.isfinite(a).all() and np.isfinite(b).all()
    ma, mb = float(a.mean()), float(b.mean())
    assert abs(ma - mb) / ma < 2e-3, (ma, mb)
    # overwhelming pixel-level agreement (the divergence class is
    # isolated near-tangency rays, not structural)
    frac_diff = (np.abs(a - b).max(-1) > 1e-3).mean()
    assert frac_diff < 0.005, frac_diff


def test_auto_policy():
    """auto_use_bvh follows the default backend's measured crossover
    (backend._BVH_MIN_PRIMS, keyed by backend; CPU here)."""
    from raytracing_rust_tpu import backend
    assert jax.default_backend() == "cpu"
    assert backend.bvh_min_prims() == backend._BVH_MIN_PRIMS["cpu"]
    assert set(backend._BVH_MIN_PRIMS) == {"cpu", "gpu"}
    small = big_spheres(300)
    big = big_spheres(12000)
    assert small.num_prims < backend.bvh_min_prims() <= big.num_prims
    assert not auto_use_bvh(small)
    assert auto_use_bvh(big)


def test_auto_policy_gpu_crossover(monkeypatch):
    """On a GPU backend the policy switches at the H100 crossover, not
    the CPU's: a 12k-primitive scene stays on the dense scan."""
    from raytracing_rust_tpu import backend
    monkeypatch.setattr(backend.jax, "default_backend", lambda: "gpu")
    assert backend.bvh_min_prims() == backend._BVH_MIN_PRIMS["gpu"]
    assert not auto_use_bvh(big_spheres(12000))
    assert auto_use_bvh(big_spheres(30000))


def test_bvh_node_bounds_contain_prims():
    """Node f32 bounds must CONTAIN their primitives' f64 bounds (the
    outward-rounding cast — a nearest-cast can shrink a node half an
    ulp and drop grazing hits)."""
    from raytracing_rust_tpu.accel.bvh import build_bvh, prim_aabbs
    scene = big_spheres(5000)
    lo, hi = prim_aabbs(scene)
    bvh = build_bvh(scene)
    nmin = np.asarray(bvh.node_min, np.float64)
    nmax = np.asarray(bvh.node_max, np.float64)
    # root must contain every prim
    assert (nmin[0] <= lo.min(0)).all() and (nmax[0] >= hi.max(0)).all()
