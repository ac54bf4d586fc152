"""Render driver: the data-parallel equivalent of the reference's
`create_image` (reference tests/test.rs:55-85).

The reference triple loop (rows j=ny−1..0, cols i=0..nx, ns samples, one
recursive `color` per sample) becomes: flat pixel ids → ray lanes
(pixel × sample), traced as one wavefront batch under jit, accumulated into
per-pixel radiance sums. A host-side loop walks pixel blocks × sample chunks
so arbitrarily large (nx, ny, spp) fit in device memory; each (block, chunk)
gets its own folded RNG key, so the full render is deterministic for a given
seed regardless of chunking-independent lane position.

Output matches the reference exactly: image row 0 is the top scanline
(j = ny−1), gamma 2.0 via sqrt, clamp to [0,1] (tests/test.rs:72-75).
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .models.scene import SceneTables
from .ops.camera import Camera, get_rays
from .ops.integrator import run_bounces, trace
from .ops.intersect import pack_prims

_CAM_FOLD = 1 << 20  # RNG purpose slot for camera jitter draws

# per-DISPATCH ray cap for the plain (compact=False) XLA path: bounds the
# work of one program so progress and checkpoints stay fine-grained. Module
# constant so tests can shrink it and pin grouping-invariance.
_DISPATCH_RAY_BUDGET = 1 << 24

# Checkpoint estimator-version: bump whenever a code change alters the
# image for identical (scene, camera, config) — e.g. an RNG relayout.
# The content digest hashes DATA, not code; without this a partial
# checkpoint written by an older build would resume under the new
# estimator and silently produce a hybrid image no uninterrupted run
# can reproduce. v2 = round-4 lane-keyed bounce RNG.
_CK_LAYOUT_VERSION = 2


def _render_digest(scene: SceneTables, cam: Camera, use_bvh: bool) -> int:
    """63-bit content digest of everything that changes a render's output
    beyond the explicit ck_meta scalars — scene tables, camera, BVH use —
    so a stale checkpoint from a different scene/camera is discarded
    instead of silently merged."""
    h = hashlib.sha256()
    scene_np, cam_np = jax.device_get((scene, cam))  # one batched pull
    for leaf in jax.tree.leaves(scene_np) + jax.tree.leaves(cam_np):
        h.update(np.asarray(leaf).tobytes())
    h.update(bytes([int(use_bvh)]))
    # EVERY static (aux-data) field changes the compiled program and the
    # image — hash them all by name so a new flag can't be forgotten
    # (compat_uv_bug was, once: two runs differing only in the sphere-UV
    # quirk would have merged checkpoints)
    for fld in dataclasses.fields(scene):
        if fld.metadata.get("static"):
            h.update(fld.name.encode())
            h.update(repr(getattr(scene, fld.name)).encode())
    return int.from_bytes(h.digest()[:8], "little") >> 1


@partial(jax.jit, static_argnames=("spp", "nx", "ny", "max_depth",
                                   "n_chunks", "rr_depth"))
def render_block_multi(scene: SceneTables, cam: Camera, pix: jnp.ndarray,
                       key: jax.Array, spp: int, nx: int, ny: int,
                       max_depth: int, n_chunks: int, bvh=None,
                       rr_depth=None, ch0=0):
    """`n_chunks` sequential sample chunks of one pixel block in a SINGLE
    dispatch (lax.fori over the chunk id, radiance accumulated on device).

    Each chunk folds its ABSOLUTE id (ch0 + local id) into the key
    exactly like the host loop in `render`, so images are identical to
    dispatch-per-chunk rendering regardless of how the host groups
    chunks into dispatches. ch0 is a traced scalar so every group of the
    same size reuses one compile.
    """
    def chunk(ch, acc):
        k = jax.random.fold_in(key, ch0 + ch)
        return acc + render_block(scene, cam, pix, k, spp, nx, ny,
                                  max_depth, bvh=bvh, rr_depth=rr_depth)

    init = jnp.zeros((pix.shape[0], 3), cam.origin.dtype)
    return jax.lax.fori_loop(0, n_chunks, chunk, init)


@partial(jax.jit, static_argnames=("spp", "nx", "ny", "max_depth",
                                   "differentiable", "rr_depth"))
def render_block(scene: SceneTables, cam: Camera, pix: jnp.ndarray,
                 key: jax.Array, spp: int, nx: int, ny: int,
                 max_depth: int = 50, differentiable: bool = False,
                 bvh=None, rr_depth=None):
    """Radiance sums over `spp` samples for a block of pixel ids → [Nb, 3].

    pix: int32[Nb] flat pixel ids in output order (0 = top-left, row-major).
    """
    nb = pix.shape[0]
    o, d, time = camera_lane_rays(cam, jnp.repeat(pix, spp), key, nx, ny)
    rad = trace(scene, o, d, time, key, max_depth=max_depth,
                differentiable=differentiable, bvh=bvh, rr_depth=rr_depth)
    return rad.reshape(nb, spp, 3).sum(axis=1)


# ---------------------------------------------------------------------------
# Compacted wavefront: the XLA tier's answer to dead-lane waste.
#
# The while_loop in `trace` runs until EVERY lane dies — measured on
# cornell_box that is all 51 bounces at full width while the mean path is
# ~4.6 bounces (alive fraction 11% by bounce 10, 2% by bounce 20), i.e.
# ~10x more bounce-width than the paths need. The fix: run a few bounces
# at full width
# (the head), then gather the survivors into a power-of-two-width batch
# and continue (tails), re-compacting at schedule boundaries. Lane RNG is
# addressed by ORIGINAL lane id (integrator._lane_draws), so the compacted
# render is BIT-IDENTICAL to the uncompacted one — pinned by
# tests/test_integrator.py::test_render_compaction_bit_identical.
# ---------------------------------------------------------------------------

# re-compaction boundaries (bounce indices). After the head (bounce 0-5)
# survivors compact; segment ends re-compact to the new (smaller) width.
# Each boundary costs one dispatch + one alive-count host pull (chunk 0
# only), so the schedule is coarse. Measured A/B on CPU (DESIGN.md):
# (6,12,24) beats (6,16) by 18%; coarser (6,) loses 1.5x.
_COMPACT_SCHEDULE = (6, 12, 24)


@partial(jax.jit, static_argnames=("spp", "nx", "ny", "max_depth", "s1",
                                   "rr_depth"))
def _compact_head(scene: SceneTables, cam: Camera, pix, key, spp: int,
                  nx: int, ny: int, max_depth: int, s1: int, bvh=None,
                  rr_depth=None):
    """Raygen + bounces 0 ≤ b < s1 at full width. Returns the live
    wavefront state and the survivor count (the ONLY value the host
    pulls)."""
    o, d, time = camera_lane_rays(cam, jnp.repeat(pix, spp), key, nx, ny)
    thr = jnp.ones_like(o)
    rad = jnp.zeros_like(o)
    alive = jnp.ones(o.shape[0], bool)
    pack = pack_prims(scene)
    o, d, thr, rad, alive = run_bounces(
        scene, pack, key, max_depth, 0, s1, o, d, time, thr, rad, alive,
        bvh=bvh, rr_depth=rr_depth)
    return o, d, time, thr, rad, alive, alive.sum()


@partial(jax.jit, static_argnames=("max_depth", "w", "rr_depth"))
def _compact_tail(scene: SceneTables, o, d, time, thr, rad, alive, key,
                  b0, b_end, w: int, max_depth: int, bvh=None,
                  rr_depth=None):
    """Gather the ≤w survivors, run bounces b0 ≤ b < b_end at width w,
    scatter the state back to full width.

    Survivor rows beyond w (only possible when the host reused a stale
    width — see render_block_compact) are NOT advanced; `ok` reports
    whether the width actually covered the count so the host can redo the
    chunk exactly. Fill rows gather via an out-of-range index (clipped on
    gather, dropped on scatter) and are masked dead, so they never touch
    real lanes."""
    n_total = o.shape[0]
    cnt = alive.sum()
    ok = cnt <= w
    idx = jnp.nonzero(alive, size=w, fill_value=n_total)[0]
    valid = jnp.arange(w) < cnt
    g = lambda x: x[idx]
    rad_c = jnp.zeros((w, 3), o.dtype)
    pack = pack_prims(scene)
    o_c, d_c, thr_c, rad_c, alive_c = run_bounces(
        scene, pack, key, max_depth, b0, b_end, g(o), g(d), g(time),
        g(thr), rad_c, valid, bvh=bvh, rr_depth=rr_depth, lane=idx)
    upd = lambda full, c: full.at[idx].set(c, mode="drop")
    alive2 = alive.at[idx].set(alive_c, mode="drop")
    return (upd(o, o_c), upd(d, d_c), upd(thr, thr_c),
            rad.at[idx].add(rad_c, mode="drop"), alive2, alive2.sum(), ok)


def _pow2_width(count: int, n_total: int) -> int:
    return min(n_total, 1 << max(1, (max(count, 1) - 1).bit_length()))


@partial(jax.jit, static_argnames=("spp", "nx", "ny", "max_depth", "s1",
                                   "widths", "bounds", "rr_depth"))
def _compact_chunk_fused(scene: SceneTables, cam: Camera, pix, key, acc,
                         spp: int, nx: int, ny: int, max_depth: int,
                         s1: int, widths: tuple, bounds: tuple, bvh=None,
                         rr_depth=None):
    """A whole sample chunk — raygen, head, every compaction stage, and
    the pixel reduction — in ONE dispatch, for callers that already know
    the stage widths (chunks after chunk 0: the block's chunks render the
    same pixels, so chunk 0's measured widths transfer). The staged
    head/tail pair costs one dispatch per schedule boundary; this path
    costs one total.

    Bit-equality with the staged path (and therefore with the plain
    full-width path): each stage's radiance delta scatters back into the
    full-width rad buffer, so the final per-pixel reduction sees the
    same values in the same order. Returns (acc + per-pixel sums, ok) —
    ok False iff any stage's survivor count overflowed its width (the
    caller then redoes the block exactly, as with the staged path).
    """
    nb = pix.shape[0]
    o, d, time = camera_lane_rays(cam, jnp.repeat(pix, spp), key, nx, ny)
    n_total = o.shape[0]
    thr = jnp.ones_like(o)
    rad_full = jnp.zeros_like(o)
    alive = jnp.ones(n_total, bool)
    lane = jnp.arange(n_total, dtype=jnp.int32)
    pack = pack_prims(scene)
    o, d, thr, rad_full, alive = run_bounces(
        scene, pack, key, max_depth, 0, s1, o, d, time, thr, rad_full,
        alive, bvh=bvh, rr_depth=rr_depth)
    ok = jnp.asarray(True)
    b0 = s1
    cur = n_total  # current batch width (fill value for nonzero)
    for w, b_end in zip(widths, bounds):
        cnt = alive.sum()
        ok = ok & (cnt <= w)
        idx = jnp.nonzero(alive, size=w, fill_value=cur)[0]
        valid = jnp.arange(w) < cnt
        g = lambda x: x[idx]
        o, d, time, thr, lane = g(o), g(d), g(time), g(thr), g(lane)
        rad_c = jnp.zeros((w, 3), o.dtype)
        o, d, thr, rad_c, alive = run_bounces(
            scene, pack, key, max_depth, b0, b_end, o, d, time, thr,
            rad_c, valid, bvh=bvh, rr_depth=rr_depth, lane=lane)
        # fill rows carry a clamped duplicate lane id — drop by validity
        rad_full = rad_full.at[lane].add(
            jnp.where(valid[:, None], rad_c, 0.0))
        b0 = b_end
        cur = w
    return _reduce_block(rad_full, acc, nb, spp), ok


@partial(jax.jit, static_argnames=("nb", "spp"))
def _reduce_block(rad, acc, nb: int, spp: int):
    """Lane radiance [nb·spp, 3] → per-pixel sums added onto acc, as ONE
    dispatch instead of an eager reshape+sum+add chain; the sequential
    per-chunk adds also keep the f32 accumulation order
    identical to the plain path's host loop, so compact stays
    bit-identical."""
    return acc + rad.reshape(nb, spp, 3).sum(axis=1)


def render_block_compact(scene: SceneTables, cam: Camera, pix, key,
                         spp: int, nx: int, ny: int, max_depth: int,
                         bvh=None, rr_depth=None, widths=None,
                         schedule=_COMPACT_SCHEDULE, acc=None):
    """`render_block` with wavefront compaction — bit-identical output.

    widths: optional pre-chosen tail widths (one per schedule segment).
    Chunks of the same block are statistically identical, so the host
    measures chunk 0's survivor counts once and reuses those widths for
    the rest — skipping the per-segment count pulls (host syncs).
    Power-of-two rounding gives the reuse its safety
    margin; if a later chunk still overflows a reused width (count noise
    is ~0.1%, so this is essentially never), `ok` comes back False and
    the caller redoes the block with exact pulls
    (test_render_compaction_overflow_redo exercises both sides).

    acc: optional device [nb, 3] accumulator the per-pixel sums are
    added onto (one fused dispatch) so a multi-chunk caller never
    pulls or eagerly adds per chunk.

    Returns (per_pixel_sums, widths_used, ok_flags) — sums and ok_flags
    are DEVICE values so callers can defer the pull.
    """
    nb = pix.shape[0]
    n_total = nb * spp
    s1 = min(schedule[0], max_depth + 1)
    o, d, time, thr, rad, alive, cnt = _compact_head(
        scene, cam, pix, key, spp, nx, ny, max_depth, s1, bvh=bvh,
        rr_depth=rr_depth)
    bounds = [s for s in schedule[1:] if s <= max_depth] + [max_depth + 1]
    used = []
    oks = []
    b0 = s1
    for seg, b_end in enumerate(bounds):
        if b0 > max_depth:
            break
        if widths is not None and seg < len(widths):
            w = widths[seg]
        else:
            c = int(jax.device_get(cnt))
            if c == 0:
                break
            w = _pow2_width(c, n_total)
        o, d, thr, rad, alive, cnt, ok = _compact_tail(
            scene, o, d, time, thr, rad, alive, key,
            jnp.asarray(b0, jnp.int32), jnp.asarray(b_end, jnp.int32),
            w, max_depth, bvh=bvh, rr_depth=rr_depth)
        used.append(w)
        oks.append(ok)
        b0 = b_end
    if acc is None:
        acc = jnp.zeros((nb, 3), rad.dtype)
    return _reduce_block(rad, acc, nb, spp), used, oks


def camera_lane_rays(cam: Camera, pid: jnp.ndarray, key, nx: int, ny: int,
                     lane=None, n_total=None):
    """Flat pixel id per lane → (o, d, time) camera rays with the
    reference's sub-pixel jitter (tests/test.rs:62-68; row 0 = top via
    the j flip). The ONE pixel-mapping + jitter-draw implementation,
    shared by render_block (XLA tier) and parallel.sharding's lane grid —
    a second copy would let the tiers' RNG layouts silently drift.

    lane/n_total: as in integrator._lane_draws — when this batch is a
    shard of an n_total-lane wavefront, draw the full jitter table and
    gather the rows these lanes own, so per-lane rays do not depend on
    how lanes are partitioned across devices."""
    i = (pid % nx).astype(cam.origin.dtype)
    j = (ny - 1 - pid // nx).astype(cam.origin.dtype)  # reference row order
    cam_key = jax.random.fold_in(key, _CAM_FOLD)
    if lane is None:
        u = jax.random.uniform(cam_key, (pid.shape[0], 5), cam.origin.dtype)
    else:
        u = jax.random.uniform(cam_key, (n_total, 5), cam.origin.dtype)[lane]
    s = (i + u[:, 0]) / nx
    t = (j + u[:, 1]) / ny
    return get_rays(cam, s, t, u[:, 2:5])


def auto_use_bvh(scene: SceneTables) -> bool:
    """The measured large-scene policy: the BVH from the backend's
    dense-scan/BVH crossover on (backend.bvh_min_prims)."""
    from .backend import bvh_min_prims
    return scene.num_prims >= bvh_min_prims()


def render(scene: SceneTables, cam: Camera, nx: int, ny: int, spp: int,
           seed: int = 0, max_depth: int = 50, block_pixels: int = 1 << 16,
           spp_chunk: int | None = None, progress=None,
           use_bvh: bool | None = None, checkpoint: str | None = None,
           rr_depth: int | None = None, timers=None,
           compact: bool = True) -> np.ndarray:
    """Full image render → float32 [ny, nx, 3], gamma-corrected like the
    reference (sqrt + clamp, tests/test.rs:72-75). Row 0 = top.

    checkpoint: optional .npz path — per-block radiance sums are saved
    after each pixel block and a matching partial render resumes from the
    last completed block, bit-identical to an uninterrupted run (each
    block's RNG key depends only on (seed, block id)). The reference has
    no resume at all (SURVEY.md §5: whole image in one String).

    compact: wavefront compaction (see render_block_compact) — the
    default; bit-identical to compact=False, which survives as the
    plain grouped-dispatch path (and its own invariance test).

    use_bvh: None = auto (see auto_use_bvh — BVH only where it
    measures faster); True/False force the path.
    """
    if use_bvh is None:
        use_bvh = auto_use_bvh(scene)
    if use_bvh:
        # BVH traversal carries a per-lane stack: cap the per-DISPATCH
        # chain count (block_pixels·spp_chunk, since BVH blocks dispatch
        # per chunk below — capping block_pixels alone stops bounding
        # anything once spp > 2^16/block).
        block_pixels = min(block_pixels, max(256, (1 << 16) // spp))
    block_pixels = min(block_pixels, nx * ny)
    if spp_chunk is None:
        # lane budget per dispatch: big enough to amortize dispatch and
        # host-sync overhead, small enough for the [lanes, P]
        # intersection temps (~4 MB/lane-million/prim); smaller for the
        # BVH's per-lane stacks (see above)
        budget = max(1, ((1 << 16) if use_bvh else (1 << 22))
                     // block_pixels)
        # largest divisor of spp within the lane budget (one jit shape)
        spp_chunk = max(c for c in range(1, min(spp, budget) + 1)
                        if spp % c == 0)
    assert spp % spp_chunk == 0, "spp_chunk must divide spp"
    n_pix = nx * ny
    n_blocks = math.ceil(n_pix / block_pixels)
    n_chunks = spp // spp_chunk

    if timers is None:
        from .utils.timers import Timers
        timers = Timers()  # unobserved sink; keeps the loop branch-free

    bvh = None
    if use_bvh:
        from .accel.bvh import build_bvh
        with timers.phase("bvh_build"):
            bvh = build_bvh(scene)

    base = jax.random.key(seed)
    sums = np.zeros((n_pix, 3), np.float32)
    start_blk = 0
    ck_meta = None
    if checkpoint:
        # digest only when checkpointing: it materializes every scene
        # leaf on the host
        ck_meta = np.asarray([_CK_LAYOUT_VERSION, nx, ny, spp, seed,
                              max_depth, block_pixels, spp_chunk,
                              -1 if rr_depth is None else rr_depth,
                              _render_digest(scene, cam, use_bvh)])
    if checkpoint and os.path.exists(checkpoint):
        ck = np.load(checkpoint)
        if np.array_equal(ck["meta"], ck_meta):
            sums = ck["sums"]
            start_blk = int(ck["next_block"])

    done = start_blk * n_chunks
    for blk in range(start_blk, n_blocks):
        lo = blk * block_pixels
        hi = min(lo + block_pixels, n_pix)
        ids = np.arange(lo, lo + block_pixels, dtype=np.int32)
        ids[hi - lo:] = n_pix - 1  # pad: re-render last pixel, discarded
        pix = jnp.asarray(ids)
        blk_key = jax.random.fold_in(base, blk)
        # the first block's dispatch carries the jit compile; np.asarray
        # ends each phase at a device sync
        pname = "compile+block0" if blk == start_blk else "dispatch"
        with timers.phase(pname):
            if compact:
                # dead-lane compaction, per chunk; chunk 0 measures the
                # survivor counts, later chunks reuse its widths (the
                # chunks render the same pixels, so counts differ by
                # ~0.1%). Chunk sums accumulate ON DEVICE through the
                # _reduce_block carry; sums + ok flags pull ONCE per
                # block. If a reused width ever overflowed (ok False —
                # essentially never), redo the whole block with exact
                # per-segment pulls.
                s1_blk = min(_COMPACT_SCHEDULE[0], max_depth + 1)
                bounds_blk = tuple(
                    s for s in _COMPACT_SCHEDULE[1:] if s <= max_depth
                ) + (max_depth + 1,)

                def run_block(reuse_widths: bool):
                    widths = None
                    total, oks = None, []
                    for ch in range(n_chunks):
                        k = jax.random.fold_in(blk_key, ch)
                        if (reuse_widths and widths is not None
                                and len(widths) == len(bounds_blk)):
                            # widths known for the FULL schedule → the
                            # whole chunk fuses into one dispatch
                            total, ok = _compact_chunk_fused(
                                scene, cam, pix, k, total, spp_chunk,
                                nx, ny, max_depth, s1_blk, tuple(widths),
                                bounds_blk, bvh=bvh, rr_depth=rr_depth)
                            oks.append(ok)
                            continue
                        total, used, ok = render_block_compact(
                            scene, cam, pix, k, spp_chunk, nx, ny,
                            max_depth, bvh=bvh, rr_depth=rr_depth,
                            widths=widths, acc=total)
                        if reuse_widths and widths is None:
                            widths = used
                        oks.extend(ok)
                    return total, oks

                total, oks = run_block(reuse_widths=True)
                acc, ok_np = jax.device_get((total, oks))  # one pull
                if not all(bool(x) for x in ok_np):
                    total, _ = run_block(reuse_widths=False)
                    acc = np.asarray(total)
            elif use_bvh and n_chunks > 1:
                # dispatch PER CHUNK: the single-dispatch fori over chunks
                # would hold block_pixels·spp chains' stacks regardless of
                # spp_chunk. Identical key folding →
                # identical image (render_block_multi docstring contract).
                acc = np.zeros((block_pixels, 3), np.float32)
                for ch in range(n_chunks):
                    k = jax.random.fold_in(blk_key, ch)
                    acc += np.asarray(render_block(
                        scene, cam, pix, k, spp_chunk, nx, ny, max_depth,
                        bvh=bvh, rr_depth=rr_depth))
            else:
                # cap per-DISPATCH work: a single fori dispatch over ALL
                # chunks scales with full spp, so group chunks to at
                # most ~2^24 rays per dispatch (progress and checkpoints
                # stay fine-grained). Image-invariant: absolute chunk
                # ids fold into
                # the key (render_block_multi ch0), and equal-size
                # groups share one compile.
                acc = np.zeros((block_pixels, 3), np.float32)
                g0 = 0
                for g in dispatch_group_sizes(block_pixels, spp_chunk,
                                              n_chunks):
                    acc += np.asarray(render_block_multi(
                        scene, cam, pix, blk_key, spp_chunk, nx, ny,
                        max_depth, g, bvh=bvh, rr_depth=rr_depth,
                        ch0=g0))
                    g0 += g
        done += n_chunks
        if progress is not None:
            progress(done, n_blocks * n_chunks)
        sums[lo:hi] += acc[: hi - lo]
        if checkpoint:
            with timers.phase("checkpoint_io"):
                tmp = checkpoint + ".tmp.npz"
                np.savez(tmp, meta=ck_meta, sums=sums, next_block=blk + 1)
                os.replace(tmp, checkpoint)

    return finalize_image(sums, spp, nx, ny)


def dispatch_group_sizes(block_pixels: int, spp_chunk: int,
                         n_chunks: int) -> list[int]:
    """How the XLA tier groups a block's sample chunks into dispatches:
    full groups of `_DISPATCH_RAY_BUDGET // (block_pixels·spp_chunk)`
    chunks plus one ragged tail. Drives the compact=False path only
    (the compact path caps per-dispatch work by construction: the head
    is a few bounces, tails run at compacted widths)."""
    group = max(1, _DISPATCH_RAY_BUDGET // (block_pixels * spp_chunk))
    return [min(group, n_chunks - g0) for g0 in range(0, n_chunks, group)]


def finalize_image(sums: np.ndarray, spp: int, nx: int, ny: int) -> np.ndarray:
    """Radiance sums → display image: the reference's gamma √ + clamp
    (tests/test.rs:72-75). The ONE implementation of the output contract,
    shared by render() and parallel.sharding.render_sharded — a second
    copy would let the tiers' gamma/clamp drift (same rule as
    camera_lane_rays)."""
    img = np.sqrt(np.clip(sums / spp, 0.0, None))
    return np.clip(img, 0.0, 1.0).reshape(ny, nx, 3).astype(np.float32)


def render_auto(scene: SceneTables, cam: Camera, nx: int, ny: int, spp: int,
                **kw) -> tuple[np.ndarray, str]:
    """Render on the GPU kernel where it compiles (backend.gpu_kernels)
    and covers the scene, else on the XLA tier → (image, engine). kw:
    the options both tiers share (seed, max_depth, rr_depth, spp_chunk,
    checkpoint, timers, progress)."""
    from .backend import gpu_kernels
    from .ops.pallas_tracer import UnsupportedScene, render_pallas
    if gpu_kernels():
        try:
            return render_pallas(scene, cam, nx, ny, spp, **kw), "pallas"
        except UnsupportedScene:
            pass
    return render(scene, cam, nx, ny, spp, **kw), "xla"
