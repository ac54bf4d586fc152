"""Multi-chip / multi-host render + gradient sharding.

The reference is a single-threaded CPU program (SURVEY.md §2: rayon declared
but unused, Rc-based BVH). This build scales the two embarrassingly
parallel axes over a `jax.sharding.Mesh`:

* `dp` — pixel tiles (data parallelism over the image);
* `sp` — samples-per-pixel batches (the "long dimension" analogue;
  partial radiance sums reduce over this axis).

We annotate lane arrays with `NamedSharding` and let GSPMD insert the
collectives (psum over `sp` for radiance, psum over the whole mesh for
parameter gradients in the differentiable path; on GPUs XLA hands them
to NCCL) — the idiomatic JAX answer to NCCL/MPI (SURVEY.md §5
"Distributed communication backend"). Multi-host runs
use the same code after `jax.distributed.initialize()`.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.scene import SceneTables
from ..ops.camera import Camera
from ..ops.integrator import run_bounces, trace
from ..ops.intersect import pack_prims
from ..render import camera_lane_rays, finalize_image


def make_mesh(devices=None, dp: int | None = None, sp: int | None = None) -> Mesh:
    """Build a (dp, sp) mesh over all (or given) devices.

    Defaults put every device on `dp` (pixel tiles) — best for single-host
    throughput; pass sp>1 to also spread samples of the same pixels.
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if dp is None and sp is None:
        dp, sp = n, 1
    elif dp is None:
        dp = n // sp
    elif sp is None:
        sp = n // dp
    assert dp * sp == n, f"mesh {dp}x{sp} != {n} devices"
    return Mesh(devices.reshape(dp, sp), ("dp", "sp"))


def _lane_radiance(scene: SceneTables, cam: Camera, pix, key, nx: int, ny: int,
                   spp: int, max_depth: int, differentiable: bool,
                   rr_depth=None):
    """Radiance sums [Npix, 3] for a [Npix, spp] lane grid.

    pix: int32[Npix]; lanes laid out [Npix, spp] so sharding P('dp','sp')
    splits pixels over dp and samples over sp.
    """
    npix = pix.shape[0]
    # flat [npix·spp] lane order (pixel-major) matches render_block's —
    # the mapping + jitter draws come from the ONE shared implementation
    pid = jnp.broadcast_to(pix[:, None], (npix, spp)).reshape(-1)
    o, d, time = camera_lane_rays(cam, pid, key, nx, ny)
    rad = trace(scene, o, d, time, key, max_depth=max_depth,
                differentiable=differentiable, rr_depth=rr_depth)
    return rad.reshape(npix, spp, 3).sum(axis=1)


@partial(jax.jit, static_argnames=("nx", "ny", "spp", "max_depth", "mesh",
                                   "rr_depth"))
def render_block_sharded(scene: SceneTables, cam: Camera, pix, key,
                         nx: int, ny: int, spp: int, max_depth: int,
                         mesh: Mesh, rr_depth=None):
    """Forward render of a pixel block, sharded (pixels × samples) over mesh.

    Scene/camera replicate; the [Npix, spp] lane grid shards P('dp', 'sp');
    the sample-axis sum reduces partial radiance over `sp` (GSPMD psum).
    """
    pix = jax.lax.with_sharding_constraint(
        pix, NamedSharding(mesh, P("dp")))
    out = _lane_radiance(scene, cam, pix, key, nx, ny, spp, max_depth, False,
                         rr_depth=rr_depth)
    return jax.lax.with_sharding_constraint(
        out, NamedSharding(mesh, P("dp", None)))


# ---------------------------------------------------------------------------
# Sharded wavefront compaction (render.py "Compacted wavefront", per shard).
#
# GSPMD can't express the survivor gather (jnp.nonzero is global under
# GSPMD), so the compacted forward path drops to shard_map: every device
# compacts ITS lanes to one host-chosen static width. Lane RNG stays
# addressed by GLOBAL lane id (integrator._lane_draws + camera_lane_rays'
# lane gather), so per-lane radiance is bit-identical to the GSPMD path
# and therefore mesh-layout-invariant for the same reason it already was.
# ---------------------------------------------------------------------------

_SHARD_SCHEDULE = None  # None → render._COMPACT_SCHEDULE (one source)


def _shard_schedule():
    from ..render import _COMPACT_SCHEDULE
    return _SHARD_SCHEDULE or _COMPACT_SCHEDULE


@partial(jax.jit, static_argnames=("nx", "ny", "spp", "max_depth", "mesh",
                                   "rr_depth", "s1"))
def _head_sharded(scene: SceneTables, cam: Camera, pix, key, nx: int,
                  ny: int, spp: int, max_depth: int, mesh: Mesh,
                  s1: int, rr_depth=None):
    """Raygen + bounces 0..s1 per shard → (state..., per-shard counts)."""
    npix = pix.shape[0]
    n_total = npix * spp
    lanes = jnp.arange(n_total, dtype=jnp.int32).reshape(npix, spp)

    def body(scene, cam, pix_t, lane_t, key):
        lane = lane_t.reshape(-1)
        pid = jnp.broadcast_to(pix_t[:, None], lane_t.shape).reshape(-1)
        o, d, time = camera_lane_rays(cam, pid, key, nx, ny, lane=lane,
                                      n_total=n_total)
        thr = jnp.ones_like(o)
        rad = jnp.zeros_like(o)
        # pcast: a fresh constant is shard-UNvarying to shard_map's type
        # system, but the loop body makes it varying — declare it
        # (thr/rad derive from the varying o, so they're already varying)
        alive = jax.lax.pcast(jnp.ones(lane.shape[0], bool), ("dp", "sp"),
                              to="varying")
        pack = pack_prims(scene)
        o, d, thr, rad, alive = run_bounces(
            scene, pack, key, max_depth, 0, s1, o, d, time, thr, rad,
            alive, rr_depth=rr_depth, lane=lane)
        # pmax → REPLICATED max survivor count: the host pulls one
        # scalar (not a mesh-sharded array, which a multi-process mesh
        # could not even device_get), and every process computes the
        # same stage width
        cnt = jax.lax.pmax(alive.sum(), ("dp", "sp"))
        return o, d, time, thr, rad, alive, lane, cnt

    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P("dp"), P("dp", "sp"), P()),
        out_specs=(P(("dp", "sp")),) * 7 + (P(),))
    return fn(scene, cam, pix, lanes, key)


@partial(jax.jit, static_argnames=("w", "max_depth", "mesh", "rr_depth"))
def _stage_sharded(scene: SceneTables, state, key, w: int, b0, b_end,
                   max_depth: int, mesh: Mesh, rr_depth=None):
    """ONE compaction stage per shard: compact each shard's survivors to
    width w, run bounces b0 ≤ b < b_end, scatter the state back to the
    shard's full width → (state', per-shard counts, ok flags). The
    sharded analogue of render._compact_tail; b0/b_end are traced so
    every stage of a schedule shares one compiled program per width."""

    def body(scene, o, d, time, thr, rad, alive, lane, key):
        nl = o.shape[0]
        cnt = alive.sum()
        # replicated over/next-count scalars (see _head_sharded's pmax)
        ok = jax.lax.pmin((cnt <= w).astype(jnp.int32), ("dp", "sp")) > 0
        idx = jnp.nonzero(alive, size=w, fill_value=nl)[0]
        valid = jnp.arange(w) < cnt
        g = lambda x: x[idx]
        pack = pack_prims(scene)
        rad_c = jax.lax.pcast(jnp.zeros((w, 3), o.dtype), ("dp", "sp"),
                              to="varying")
        o_c, d_c, thr_c, rad_c, alive_c = run_bounces(
            scene, pack, key, max_depth, b0, b_end, g(o), g(d),
            g(time), g(thr), rad_c, valid, rr_depth=rr_depth,
            lane=g(lane))
        upd = lambda full, c: full.at[idx].set(c, mode="drop")
        alive2 = alive.at[idx].set(alive_c, mode="drop")
        cnt2 = jax.lax.pmax(alive2.sum(), ("dp", "sp"))
        return (upd(o, o_c), upd(d, d_c), upd(thr, thr_c),
                rad.at[idx].add(rad_c, mode="drop"), alive2, cnt2, ok)

    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(),) + (P(("dp", "sp")),) * 7 + (P(),),
        out_specs=((P(("dp", "sp")),) * 4
                   + (P(("dp", "sp")), P(), P())))
    o, d, time, thr, rad, alive, lane = state
    o, d, thr, rad, alive, cnts, ok = fn(scene, o, d, time, thr, rad,
                                         alive, lane, key)
    return (o, d, time, thr, rad, alive, lane), cnts, ok


@partial(jax.jit, static_argnames=("npix_loc", "spp_loc", "mesh"))
def _reduce_sharded(rad, acc, npix_loc: int, spp_loc: int, mesh: Mesh):
    """Per-shard lane radiance → per-pixel sums (psum over sp) added
    onto acc, one dispatch."""

    def body(rad, acc_t):
        part = rad.reshape(npix_loc, spp_loc, 3).sum(axis=1)
        return acc_t + jax.lax.psum(part, "sp")

    fn = jax.shard_map(body, mesh=mesh,
                       in_specs=(P(("dp", "sp")), P("dp", None)),
                       out_specs=P("dp", None))
    return fn(rad, acc)


@partial(jax.jit, static_argnames=("nx", "ny", "spp", "max_depth", "mesh",
                                   "rr_depth", "s1", "widths", "bounds"))
def _chunk_sharded_fused(scene: SceneTables, cam: Camera, pix, key, acc,
                         nx: int, ny: int, spp: int, max_depth: int,
                         s1: int, widths: tuple, bounds: tuple,
                         mesh: Mesh, rr_depth=None):
    """A whole sample chunk — raygen, head, EVERY compaction stage, and
    the psum-reduced pixel sums — as ONE shard_map dispatch, for chunks
    whose stage widths are known (chunk 0 measured them; the chunks of a
    block render the same pixels). The sharded twin of
    render._compact_chunk_fused — same bit-compat argument: each
    stage's radiance delta scatters back into the shard's full-width
    rad buffer by surviving ROW, while RNG/camera draws stay addressed
    by GLOBAL lane id, so per-lane values are identical to the staged
    and plain GSPMD paths."""
    npix = pix.shape[0]
    n_total = npix * spp
    lanes = jnp.arange(n_total, dtype=jnp.int32).reshape(npix, spp)

    def body(scene, cam, pix_t, lane_t, acc_t, key):
        lane = lane_t.reshape(-1)
        nl = lane.shape[0]
        pid = jnp.broadcast_to(pix_t[:, None], lane_t.shape).reshape(-1)
        o, d, time = camera_lane_rays(cam, pid, key, nx, ny, lane=lane,
                                      n_total=n_total)
        thr = jnp.ones_like(o)
        rad_full = jnp.zeros_like(o)
        alive = jax.lax.pcast(jnp.ones(nl, bool), ("dp", "sp"),
                              to="varying")
        row = jax.lax.pcast(jnp.arange(nl, dtype=jnp.int32),
                            ("dp", "sp"), to="varying")
        pack = pack_prims(scene)
        o, d, thr, rad_full, alive = run_bounces(
            scene, pack, key, max_depth, 0, s1, o, d, time, thr,
            rad_full, alive, rr_depth=rr_depth, lane=lane)
        ok = jax.lax.pcast(jnp.asarray(True), ("dp", "sp"), to="varying")
        b0 = s1
        cur = nl
        for w, b_end in zip(widths, bounds):
            cnt = alive.sum()
            ok = ok & (cnt <= w)
            idx = jnp.nonzero(alive, size=w, fill_value=cur)[0]
            valid = jnp.arange(w) < cnt
            g = lambda x: x[idx]
            o, d, time, thr = g(o), g(d), g(time), g(thr)
            lane, row = g(lane), g(row)
            rad_c = jax.lax.pcast(jnp.zeros((w, 3), o.dtype),
                                  ("dp", "sp"), to="varying")
            o, d, thr, rad_c, alive = run_bounces(
                scene, pack, key, max_depth, b0, b_end, o, d, time, thr,
                rad_c, valid, rr_depth=rr_depth, lane=lane)
            # fill rows carry a clamped duplicate row id — drop by
            # validity (render._compact_chunk_fused's argument)
            rad_full = rad_full.at[row].add(
                jnp.where(valid[:, None], rad_c, 0.0))
            b0 = b_end
            cur = w
        part = rad_full.reshape(pix_t.shape[0], -1, 3).sum(axis=1)
        ok = jax.lax.pmin(ok.astype(jnp.int32), ("dp", "sp")) > 0
        return acc_t + jax.lax.psum(part, "sp"), ok

    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P("dp"), P("dp", "sp"), P("dp", None), P()),
        out_specs=(P("dp", None), P()))
    return fn(scene, cam, pix, lanes, acc, key)


def render_sharded(scene: SceneTables, cam: Camera, nx: int, ny: int,
                   spp: int, mesh: Mesh, seed: int = 0, max_depth: int = 50,
                   block_pixels: int | None = None,
                   rr_depth: int | None = None, progress=None,
                   timers=None, compact: bool = True,
                   spp_chunk: int | None = None) -> np.ndarray:
    """Full sharded render → float32 [ny, nx, 3] (gamma like the reference).

    Sample chunking mirrors render(): block_pixels·spp_chunk lanes per
    dispatch stay under the ~2^22 lane budget (the dense intersect
    materializes [N, P, 3] temps, and one 65536·spp-lane dispatch at
    reference spp would run out of device memory).

    compact: per-shard wavefront compaction (see _head_sharded) — needs
    spp_chunk divisible by the sp mesh axis (shard_map shapes are exact);
    falls back to the plain GSPMD path when no such chunking divides spp.
    """
    n_pix = nx * ny
    dp = mesh.shape["dp"]
    sp = mesh.shape["sp"]
    block_pixels = block_pixels or min(n_pix, 1 << 16)
    block_pixels += (-block_pixels) % dp  # divisible by dp
    budget = max(1, (1 << 22) // block_pixels)
    if spp_chunk is not None:
        # explicit chunking (tests force the multi-chunk fused program;
        # tuning). The compact path still needs sp-divisible chunks.
        assert spp % spp_chunk == 0, "spp_chunk must divide spp"
        if compact and spp_chunk % sp != 0:
            compact = False
    elif compact:
        cands = [c for c in range(1, min(spp, budget) + 1)
                 if spp % c == 0 and c % sp == 0]
        if cands:
            spp_chunk = max(cands)
        else:
            compact = False
    if spp_chunk is None:
        spp_chunk = max(c for c in range(1, min(spp, budget) + 1)
                        if spp % c == 0)
    n_chunks = spp // spp_chunk
    base = jax.random.key(seed)
    if timers is None:
        from ..utils.timers import Timers
        timers = Timers()  # unobserved sink

    sums = np.zeros((n_pix, 3), np.float32)
    n_blocks = -(-n_pix // block_pixels)
    done = 0
    for blk in range(n_blocks):
        lo = blk * block_pixels
        hi = min(lo + block_pixels, n_pix)
        ids = np.arange(lo, lo + block_pixels, dtype=np.int32)
        ids[hi - lo:] = n_pix - 1
        pix = jnp.asarray(ids)  # ONE upload per block, not per chunk
        blk_key = jax.random.fold_in(base, blk)
        pname = "compile+block0" if blk == 0 else "dispatch"
        if compact:
            with timers.phase(pname):
                out_np = _render_block_sharded_compact(
                    scene, cam, pix, blk_key, nx, ny, spp_chunk, n_chunks,
                    max_depth, mesh, rr_depth)
            sums[lo:hi] += out_np[: hi - lo]
            done += n_chunks
            if progress is not None:
                progress(done, n_blocks * n_chunks)
            continue
        for ch in range(n_chunks):
            key = jax.random.fold_in(blk_key, ch)
            with timers.phase(pname):
                out = render_block_sharded(scene, cam, pix,
                                           key, nx, ny, spp_chunk,
                                           max_depth, mesh,
                                           rr_depth=rr_depth)
                sums[lo:hi] += np.asarray(out)[: hi - lo]
            done += 1
            if progress is not None:
                progress(done, n_blocks * n_chunks)

    return finalize_image(sums, spp, nx, ny)


def _render_block_sharded_compact(scene, cam, pix, blk_key, nx, ny,
                                  spp_chunk, n_chunks, max_depth, mesh,
                                  rr_depth) -> np.ndarray:
    """All sample chunks of one pixel block through the per-shard
    MULTI-STAGE compacted pipeline (full render._COMPACT_SCHEDULE since
    round 5 — the single-boundary tail left the later re-compactions'
    win on the table, round-4 verdict weak #3). Same width-reuse +
    overflow-redo protocol as render.render_block_compact: chunk 0 runs
    the STAGED path (one dispatch per boundary, pulling each stage's
    max shard count to choose its pow2 width); chunks 1+ fuse the whole
    schedule into one dispatch with those widths; `ok` flags pull once
    per block and an overflow (essentially never) redoes the block with
    exact per-stage pulls."""
    from ..render import _pow2_width
    dp = mesh.shape["dp"]
    sp = mesh.shape["sp"]
    block_pixels = pix.shape[0]
    npix_loc = block_pixels // dp
    spp_loc = spp_chunk // sp
    nl = npix_loc * spp_loc
    schedule = _shard_schedule()
    s1 = min(schedule[0], max_depth + 1)
    bounds = tuple(b for b in schedule[1:] if b <= max_depth) + \
        (max_depth + 1,)

    def staged_chunk(ch, widths, acc):
        """One chunk via per-boundary dispatches; measures widths when
        widths is None. Returns (acc', widths_used, oks)."""
        key = jax.random.fold_in(blk_key, ch)
        state = _head_sharded(scene, cam, pix, key, nx, ny, spp_chunk,
                              max_depth, mesh, s1, rr_depth=rr_depth)
        *state, cnts = state
        state = tuple(state)
        used = []
        oks = []
        b0 = s1
        for seg, b_end in enumerate(bounds):
            if widths is not None and seg < len(widths):
                w = widths[seg]
            else:
                w = _pow2_width(int(jax.device_get(cnts)), nl)
            state, cnts, ok = _stage_sharded(
                scene, state, key, w, jnp.asarray(b0, jnp.int32),
                jnp.asarray(b_end, jnp.int32), max_depth, mesh,
                rr_depth=rr_depth)
            used.append(w)
            oks.append(ok)
            b0 = b_end
        acc = _reduce_sharded(state[4], acc, npix_loc, spp_loc, mesh)
        return acc, used, oks

    def run_block(reuse_widths):
        widths = None
        total = jnp.zeros((block_pixels, 3), jnp.float32)
        oks = []
        for ch in range(n_chunks):
            if (reuse_widths and widths is not None
                    and len(widths) == len(bounds)):
                key = jax.random.fold_in(blk_key, ch)
                total, ok = _chunk_sharded_fused(
                    scene, cam, pix, key, total, nx, ny, spp_chunk,
                    max_depth, s1, tuple(widths), bounds, mesh,
                    rr_depth=rr_depth)
                oks.append(ok)
                continue
            total, used, ok = staged_chunk(
                ch, widths if reuse_widths else None, total)
            if reuse_widths and widths is None:
                widths = used
            oks.extend(ok)
        return total, oks

    total, oks = run_block(reuse_widths=True)
    total_np, ok_np = jax.device_get((total, oks))  # one pull
    if not all(bool(ok) for ok in ok_np):
        # a reused width overflowed a chunk's survivor count — redo the
        # whole block with exact per-chunk, per-stage widths (rare
        # enough that simple beats surgical)
        total, _ = run_block(reuse_widths=False)
        total_np = np.asarray(total)
    return total_np


def train_step_sharded(scene: SceneTables, cam: Camera, pix, key, target,
                       nx: int, ny: int, spp: int, max_depth: int, mesh: Mesh):
    """One differentiable "training" step: L2 photometric loss of a sharded
    render against a target, with parameter gradients psum-reduced over the
    whole mesh by GSPMD (the ray-tracing analogue of DP gradient sync —
    SURVEY.md §2 parallelism table).

    Returns (loss, grads) where grads is a SceneTables cotangent (gradients
    flow into geometry, material params, texture colors and texels).
    """

    def loss_fn(scene):
        pix_s = jax.lax.with_sharding_constraint(
            pix, NamedSharding(mesh, P("dp")))
        sums = _lane_radiance(scene, cam, pix_s, key, nx, ny, spp,
                              max_depth, True)
        img = sums / spp
        return jnp.mean((img - target) ** 2)

    # allow_int: SceneTables mixes float parameter tables with int32 tag/index
    # tables; integer leaves get float0 cotangents.
    return jax.value_and_grad(loss_fn, allow_int=True)(scene)
