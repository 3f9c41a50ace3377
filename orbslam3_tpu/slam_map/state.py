"""Map state as fixed-capacity SoA arrays (the fixed-shape replacement for the
reference's mutex-laced KeyFrame/MapPoint object graph — SURVEY §7.1).

Parity coverage:
  * KeyFrame fields (reference include/KeyFrame.h): pose, timestamp, IMU
    velocity/bias, frame id; covisibility is *derived* (segment-sum over
    observations) instead of stored adjacency.
  * MapPoint fields (include/MapPoint.h): position, representative
    descriptor, viewing normal, scale-invariance distance range, the
    found/visible counters used by MapPointCulling.
  * Observations: COO (kf, pt, uv, octave) with validity masks — the
    equivalent of both KeyFrame::mvpMapPoints and MapPoint::mObservations.

All mutation is functional: ops return a new MapState; the host loop swaps
versioned snapshots (this replaces Map::mMutexMapUpdate semantics —
SURVEY §5.2/§7.4-7).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class MapCapacity:
    n_kf: int = 256
    n_pt: int = 24576
    n_obs: int = 196608
    n_loop_edges: int = 32   # persistent loop/merge edge slots
    n_desc_hist: int = 8     # per-point descriptor reservoir depth


class MapState(NamedTuple):
    # --- keyframes ---------------------------------------------------------
    kf_R: jnp.ndarray        # (K,3,3) R_cw
    kf_t: jnp.ndarray        # (K,3)   t_cw
    kf_vel: jnp.ndarray      # (K,3)   world-frame velocity (IMU)
    kf_bias: jnp.ndarray     # (K,6)   [gyro, acc]
    kf_ts: jnp.ndarray       # (K,)    timestamp (s)
    kf_frame_id: jnp.ndarray  # (K,)   source frame id
    kf_valid: jnp.ndarray    # (K,) bool
    # --- map points --------------------------------------------------------
    pt_xyz: jnp.ndarray      # (P,3) world
    pt_desc: jnp.ndarray     # (P,8) uint32 representative descriptor
    pt_normal: jnp.ndarray   # (P,3) mean viewing direction
    pt_min_dist: jnp.ndarray  # (P,) scale-invariance range
    pt_max_dist: jnp.ndarray  # (P,)
    pt_ref_kf: jnp.ndarray   # (P,) first-observing KF
    pt_found: jnp.ndarray    # (P,) int32 — times matched by tracker
    pt_visible: jnp.ndarray  # (P,) int32 — times predicted visible
    pt_first_frame: jnp.ndarray  # (P,) frame id at creation (culling window)
    pt_valid: jnp.ndarray    # (P,) bool
    # --- observations ------------------------------------------------------
    obs_kf: jnp.ndarray      # (O,) int32
    obs_pt: jnp.ndarray      # (O,) int32
    obs_uv: jnp.ndarray      # (O,2)
    obs_octave: jnp.ndarray  # (O,) int32
    obs_ur: jnp.ndarray      # (O,) stereo right-u (-1 = mono observation)
    obs_valid: jnp.ndarray   # (O,) bool
    # --- persistent loop/merge edges ----------------------------------------
    # The reference keeps mspLoopEdges / merge edges on KeyFrames forever
    # (include/KeyFrame.h:86-101) and every later OptimizeEssentialGraph
    # includes them (src/Optimizer.cc:1848-2179).  Fixed-capacity measured
    # Sim3 edges (i, j, S_ij with x_i = s R x_j + t), appended at every
    # loop closure / map merge and consumed by build_essential_graph.
    loop_i: jnp.ndarray      # (L,) int32
    loop_j: jnp.ndarray      # (L,) int32
    loop_R: jnp.ndarray      # (L,3,3)
    loop_t: jnp.ndarray      # (L,3)
    loop_s: jnp.ndarray      # (L,)
    loop_valid: jnp.ndarray  # (L,) bool
    n_loop: jnp.ndarray      # () int32
    # --- per-point descriptor reservoir -------------------------------------
    # ComputeDistinctiveDescriptors (reference src/MapPoint.cc:343) needs
    # the point's observation descriptors; the SoA map keeps a ring of the
    # M most recent ones (slot = count % M) so the min-median-Hamming
    # reduction is a gather + elementwise popcount, not a bank search.
    pt_desc_hist: jnp.ndarray  # (P, M, 8) uint32
    pt_desc_n: jnp.ndarray     # (P,) int32 total descriptors pushed
    # --- counters (traced scalars) ----------------------------------------
    n_kf: jnp.ndarray        # () int32 next free kf slot
    n_pt: jnp.ndarray        # () int32 next free point slot
    n_obs: jnp.ndarray       # () int32 next free obs slot
    # --- derived incidence (maintained, over-approximate) -------------------
    # (P, K) bool: point p has (ever had) an observation in KF k.  Bits are
    # ONLY set through add_observations; dead points/KFs are masked out by
    # consumers with pt_valid/kf_valid (an invalidated observation of a
    # live point leaves a stale bit — harmless over-report, see
    # covisibility_weights).  This turns covisibility, observation counts
    # and window selection — O(n_obs) gather/scatter chains — into
    # elementwise ops and one matvec.
    pt_kf_mask: jnp.ndarray


def empty_map(cap: MapCapacity) -> MapState:
    K, P, O = cap.n_kf, cap.n_pt, cap.n_obs
    L, M = cap.n_loop_edges, cap.n_desc_hist
    return MapState(
        kf_R=jnp.tile(jnp.eye(3, dtype=jnp.float32), (K, 1, 1)),
        kf_t=jnp.zeros((K, 3), jnp.float32),
        kf_vel=jnp.zeros((K, 3), jnp.float32),
        kf_bias=jnp.zeros((K, 6), jnp.float32),
        kf_ts=jnp.zeros(K, jnp.float32),
        kf_frame_id=jnp.full(K, -1, jnp.int32),
        kf_valid=jnp.zeros(K, bool),
        pt_xyz=jnp.zeros((P, 3), jnp.float32),
        pt_desc=jnp.zeros((P, 8), jnp.uint32),
        pt_normal=jnp.zeros((P, 3), jnp.float32),
        pt_min_dist=jnp.zeros(P, jnp.float32),
        pt_max_dist=jnp.full(P, jnp.inf, jnp.float32),
        pt_ref_kf=jnp.full(P, -1, jnp.int32),
        pt_found=jnp.zeros(P, jnp.int32),
        pt_visible=jnp.zeros(P, jnp.int32),
        pt_first_frame=jnp.full(P, -1, jnp.int32),
        pt_valid=jnp.zeros(P, bool),
        obs_kf=jnp.full(O, -1, jnp.int32),
        obs_pt=jnp.full(O, -1, jnp.int32),
        obs_uv=jnp.zeros((O, 2), jnp.float32),
        obs_octave=jnp.zeros(O, jnp.int32),
        obs_ur=jnp.full(O, -1.0, jnp.float32),
        obs_valid=jnp.zeros(O, bool),
        loop_i=jnp.full(L, -1, jnp.int32),
        loop_j=jnp.full(L, -1, jnp.int32),
        loop_R=jnp.tile(jnp.eye(3, dtype=jnp.float32), (L, 1, 1)),
        loop_t=jnp.zeros((L, 3), jnp.float32),
        loop_s=jnp.ones(L, jnp.float32),
        loop_valid=jnp.zeros(L, bool),
        n_loop=jnp.zeros((), jnp.int32),
        pt_desc_hist=jnp.zeros((P, M, 8), jnp.uint32),
        pt_desc_n=jnp.zeros(P, jnp.int32),
        n_kf=jnp.zeros((), jnp.int32),
        n_pt=jnp.zeros((), jnp.int32),
        n_obs=jnp.zeros((), jnp.int32),
        pt_kf_mask=jnp.zeros((P, K), bool),
    )


def add_keyframe(m: MapState, R, t, ts, frame_id, vel=None,
                 bias=None) -> tuple[MapState, jnp.ndarray]:
    """Append a keyframe; returns (map, kf_index).

    Capacity-guarded: at capacity the write is dropped (JAX OOB-scatter
    semantics) and n_kf saturates at K, so no alias slot is ever handed
    out twice.  Callers must still check n_kf < capacity before relying
    on the returned index (System does, system.py)."""
    K = m.kf_R.shape[0]
    i = m.n_kf
    m = m._replace(
        kf_R=m.kf_R.at[i].set(R),
        kf_t=m.kf_t.at[i].set(t),
        kf_ts=m.kf_ts.at[i].set(ts),
        kf_frame_id=m.kf_frame_id.at[i].set(frame_id),
        kf_vel=m.kf_vel.at[i].set(jnp.zeros(3) if vel is None else vel),
        kf_bias=m.kf_bias.at[i].set(jnp.zeros(6) if bias is None else bias),
        kf_valid=m.kf_valid.at[i].set(True),
        n_kf=jnp.minimum(i + 1, K),
    )
    return m, i


def add_points(m: MapState, xyz, desc, normal, min_dist, max_dist,
               ref_kf, frame_id, new_valid) -> tuple[MapState, jnp.ndarray]:
    """Append a fixed-size chunk of candidate points (masked by new_valid).

    Compacts the chunk so valid entries are contiguous, then writes at
    n_pt.  Returns (map, point_indices (B,) with -1 for invalid entries).
    """
    B = xyz.shape[0]
    P = m.pt_xyz.shape[0]
    v = new_valid
    # destination slot per entry via cumsum (stable, valid entries get
    # consecutive slots in original order — no argsort, no gather-blend)
    n_new = jnp.sum(v.astype(jnp.int32))
    base = m.n_pt
    dst = base + jnp.cumsum(v.astype(jnp.int32)) - 1
    # capacity guard: entries past P are dropped (returned as -1) instead
    # of silently aliasing the last slot (OOB scatter corruption)
    write = v & (dst < P)
    dst_c = jnp.where(write, dst, P)  # OOB destination => scatter dropped

    def wr(arr, vals):
        return arr.at[dst_c].set(vals, mode="drop")

    m = m._replace(
        pt_xyz=wr(m.pt_xyz, xyz),
        pt_desc=wr(m.pt_desc, desc),
        pt_normal=wr(m.pt_normal, normal),
        pt_min_dist=wr(m.pt_min_dist, min_dist),
        pt_max_dist=wr(m.pt_max_dist, max_dist),
        pt_ref_kf=wr(m.pt_ref_kf, jnp.full(B, ref_kf, jnp.int32)),
        pt_first_frame=wr(m.pt_first_frame, jnp.full(B, frame_id, jnp.int32)),
        pt_found=wr(m.pt_found, jnp.ones(B, jnp.int32)),
        pt_visible=wr(m.pt_visible, jnp.ones(B, jnp.int32)),
        pt_valid=wr(m.pt_valid, write),
        pt_desc_hist=m.pt_desc_hist.at[dst_c, 0].set(desc, mode="drop"),
        pt_desc_n=wr(m.pt_desc_n, jnp.ones(B, jnp.int32)),
        n_pt=jnp.minimum(base + n_new, P),
    )
    return m, jnp.where(write, dst, -1)


def add_loop_edge(m: MapState, i, j, R, t, s) -> MapState:
    """Persist one measured Sim3 loop/merge edge x_i = s R x_j + t
    (reference KeyFrame::AddLoopEdge / AddMergeEdge,
    include/KeyFrame.h:86-101).  Capacity-saturating like add_keyframe."""
    L = m.loop_i.shape[0]
    e = m.n_loop
    return m._replace(
        loop_i=m.loop_i.at[e].set(jnp.asarray(i, jnp.int32)),
        loop_j=m.loop_j.at[e].set(jnp.asarray(j, jnp.int32)),
        loop_R=m.loop_R.at[e].set(R),
        loop_t=m.loop_t.at[e].set(t),
        loop_s=m.loop_s.at[e].set(s),
        loop_valid=m.loop_valid.at[e].set(True),
        n_loop=jnp.minimum(e + 1, L),
    )


def add_observations(m: MapState, kf_idx, pt_idx, uv, octave,
                     valid, ur=None) -> MapState:
    """Append a fixed-size chunk of observations (masked).  `kf_idx` may
    be a scalar or a per-row (B,) array (one fused append covering several
    keyframes).  `ur`: stereo right-u per observation (-1/None = mono)."""
    B = pt_idx.shape[0]
    O = m.obs_kf.shape[0]
    if ur is None:
        ur = jnp.full(B, -1.0, jnp.float32)
    kf_arr = jnp.broadcast_to(jnp.asarray(kf_idx, jnp.int32), (B,))
    v = valid & (pt_idx >= 0)
    # destination via cumsum (stable compaction without argsort); entries
    # past capacity O are dropped (no aliasing)
    n_new = jnp.sum(v.astype(jnp.int32))
    base = m.n_obs
    dst = base + jnp.cumsum(v.astype(jnp.int32)) - 1
    write = v & (dst < O)
    dst_c = jnp.where(write, dst, O)  # OOB destination => scatter dropped

    def wr(arr, vals):
        return arr.at[dst_c].set(vals, mode="drop")

    P = m.pt_kf_mask.shape[0]
    return m._replace(
        obs_kf=wr(m.obs_kf, kf_arr),
        obs_pt=wr(m.obs_pt, pt_idx),
        obs_uv=wr(m.obs_uv, uv),
        obs_octave=wr(m.obs_octave, octave),
        obs_ur=wr(m.obs_ur, ur),
        obs_valid=wr(m.obs_valid, write),
        n_obs=jnp.minimum(base + n_new, O),
        pt_kf_mask=m.pt_kf_mask.at[
            jnp.where(write, pt_idx, P), kf_arr].max(write, mode="drop"),
    )


def live_incidence(m: MapState) -> jnp.ndarray:
    """(P, K) bool point-KF incidence with dead points/KFs masked out.

    Derived from the maintained pt_kf_mask — elementwise, no O(n_obs)
    index traffic.  Over-approximate only for (point, KF) pairs whose
    observation was individually invalidated by fusion while both
    endpoints stayed alive (the reference's covisibility graph has the
    same one-update lag until UpdateConnections reruns)."""
    return m.pt_kf_mask & m.pt_valid[:, None] & m.kf_valid[None, :]


def rebuild_incidence(m: MapState) -> MapState:
    """Recompute pt_kf_mask exactly from the observation list (one
    O(n_obs) scatter) — for splice-style map surgery (Atlas merge,
    checkpoint migration) that bypasses add_observations."""
    P = m.pt_xyz.shape[0]
    K = m.kf_R.shape[0]
    ok = m.obs_valid & (m.obs_pt >= 0) & (m.obs_kf >= 0)
    mask = jnp.zeros((P, K), bool).at[
        jnp.where(ok, m.obs_pt, P), jnp.clip(m.obs_kf, 0, K - 1)].max(
        ok, mode="drop")
    return m._replace(pt_kf_mask=mask)


def point_obs_count(m: MapState) -> jnp.ndarray:
    """(P,) number of valid observations per point (derived, replaces
    MapPoint::Observations())."""
    return jnp.sum(live_incidence(m).astype(jnp.int32), axis=1)


def covisibility_weights(m: MapState, kf_idx: jnp.ndarray) -> jnp.ndarray:
    """(K,) shared-point counts between `kf_idx` and every other KF
    (reference KeyFrame::UpdateConnections, src/KeyFrame.cc:459).

    One matvec over the live incidence grid: counts[k] =
    sum_p live[p, kf_idx] * live[p, k]."""
    live = live_incidence(m)
    seen = live[:, kf_idx].astype(jnp.float32)
    counts = jnp.einsum("p,pk->k", seen, live.astype(jnp.float32),
                        precision=jax.lax.Precision.HIGHEST)
    return counts.astype(jnp.int32).at[kf_idx].set(0)


# one f32 (P, K) transient = 32 MB at this entry count; beyond it the
# chunked path keeps the live footprint at (chunk, K)
_COVIS_DENSE_MAX_ENTRIES = 8 * 1024 * 1024


def covisibility_matrix(m: MapState, chunk: int = 8192,
                        dense_max_entries: int = _COVIS_DENSE_MAX_ENTRIES
                        ) -> jnp.ndarray:
    """(K, K) f32 shared-point counts W = A^T A over the live incidence
    (the full covisibility graph; reference KeyFrame::UpdateConnections
    pairwise counters, src/KeyFrame.cc:459).

    Small maps: one matmul over the f32-cast incidence.  Pod-scale
    maps (P*K beyond the dense cutoff): a `lax.scan` over point blocks
    accumulates W with only a (chunk, K) f32 transient — the bool
    pt_kf_mask is the only (P, K) resident, never an f32 copy.  Same
    one-update fusion lag as `covisibility_weights` (documented there)."""
    live = live_incidence(m)
    P, K = live.shape
    hi = jax.lax.Precision.HIGHEST
    if P * K <= dense_max_entries:
        A = live.astype(jnp.float32)
        return jnp.matmul(A.T, A, precision=hi)
    n_chunks = -(-P // chunk)
    pad = n_chunks * chunk - P
    blocks = jnp.pad(live, ((0, pad), (0, 0))).reshape(n_chunks, chunk, K)

    def body(W, blk):
        A = blk.astype(jnp.float32)
        return W + jnp.matmul(A.T, A, precision=hi), None

    W, _ = jax.lax.scan(body, jnp.zeros((K, K), jnp.float32), blocks)
    return W


class PointView(NamedTuple):
    """Bounded local-map view for per-frame tracking.

    The reference tracks against a LOCAL map — UpdateLocalKeyFrames picks
    the keyframes sharing points with the current frame (<=80) and
    UpdateLocalPoints collects their points (src/Tracking.cc:2964-3090) —
    precisely so per-frame cost scales with the local neighborhood, not
    the whole map.  The equivalent here: gather the covisibility
    neighborhood's points into a fixed small buffer once per keyframe, so
    the per-frame (P, N) projection/matching planes are V-sized (V ~ 8k)
    instead of capacity-sized (24k).  `idx` maps view slots back to global
    point slots (-1 = empty)."""
    xyz: jnp.ndarray       # (V, 3)
    normal: jnp.ndarray    # (V, 3)
    min_dist: jnp.ndarray  # (V,)
    max_dist: jnp.ndarray  # (V,)
    desc: jnp.ndarray      # (V, 8) uint32
    valid: jnp.ndarray     # (V,) bool
    idx: jnp.ndarray       # (V,) int32 global slot, -1 = empty


def gather_local_view(m: MapState, center_kf, n_points: int,
                      window: int = 12) -> PointView:
    """Points of the center KF's covisibility window, most-observed first
    (same budget policy as the BA window's sorted point selection).

    One covis matvec + one incidence matvec + one argsort — runs once per
    keyframe, amortized over every tracked frame in between."""
    K = m.kf_R.shape[0]
    P = m.pt_xyz.shape[0]
    covis = covisibility_weights(m, center_kf)
    kf_ids = jnp.arange(K)
    cscore = jnp.where(m.kf_valid & (kf_ids != center_kf), covis, 0)
    top_vals, top_idx = jax.lax.top_k(cscore, max(window - 1, 1))
    kf_mask = jnp.zeros(K, jnp.float32).at[top_idx].set(
        (top_vals > 0).astype(jnp.float32))
    kf_mask = kf_mask.at[center_kf].set(1.0)
    live = live_incidence(m).astype(jnp.float32)
    score = jnp.einsum("pk,k->p", live, kf_mask,
                       precision=jax.lax.Precision.HIGHEST)
    order = jnp.argsort(jnp.where(score > 0, -score, jnp.inf))
    sel = order[:n_points]
    n_in = jnp.sum((score > 0).astype(jnp.int32))
    ok = (jnp.arange(n_points) < n_in) & m.pt_valid[sel]
    return PointView(
        xyz=m.pt_xyz[sel], normal=m.pt_normal[sel],
        min_dist=m.pt_min_dist[sel], max_dist=m.pt_max_dist[sel],
        desc=m.pt_desc[sel], valid=ok,
        idx=jnp.where(ok, sel, -1).astype(jnp.int32))


def full_view(m: MapState) -> PointView:
    """Identity view over the whole point array (local view disabled)."""
    P = m.pt_xyz.shape[0]
    return PointView(xyz=m.pt_xyz, normal=m.pt_normal,
                     min_dist=m.pt_min_dist, max_dist=m.pt_max_dist,
                     desc=m.pt_desc, valid=m.pt_valid,
                     idx=jnp.arange(P, dtype=jnp.int32))


def compact(m: MapState) -> tuple[MapState, jnp.ndarray]:
    """Reclaim point/observation slots freed by culling and fusion.

    Stable-partitions valid points to the front and valid observations to
    the front, remapping obs_pt through the point permutation.  Keyframe
    slots are NOT moved (kf indices are referenced host-side by
    kf_features/kf_bindings and preintegration factor chains).

    Returns (compacted map, point_remap (P,) int32: old index -> new index
    or -1 for dropped points) — the host applies point_remap to its
    per-KF binding arrays.
    """
    P = m.pt_xyz.shape[0]
    O = m.obs_kf.shape[0]
    # ---- points
    order = jnp.argsort(~m.pt_valid)          # valid first, stable
    n_valid = jnp.sum(m.pt_valid.astype(jnp.int32))
    kept = jnp.arange(P) < n_valid
    remap = jnp.full(P, -1, jnp.int32).at[order].set(
        jnp.where(kept, jnp.arange(P, dtype=jnp.int32), -1))

    def pg(arr):
        return jnp.where(kept.reshape((P,) + (1,) * (arr.ndim - 1)),
                         arr[order], jnp.zeros_like(arr[order]))

    # ---- observations: drop ones whose point died, remap the rest
    new_pt = remap[jnp.clip(m.obs_pt, 0, P - 1)]
    ov = m.obs_valid & (m.obs_pt >= 0) & (new_pt >= 0)
    oorder = jnp.argsort(~ov)
    n_ov = jnp.sum(ov.astype(jnp.int32))
    okept = jnp.arange(O) < n_ov

    def og(arr, fill):
        out = jnp.where(okept.reshape((O,) + (1,) * (arr.ndim - 1)),
                        arr[oorder], fill)
        return out

    return m._replace(
        pt_xyz=pg(m.pt_xyz), pt_desc=pg(m.pt_desc),
        pt_normal=pg(m.pt_normal),
        pt_min_dist=pg(m.pt_min_dist), pt_max_dist=pg(m.pt_max_dist),
        pt_ref_kf=jnp.where(kept, m.pt_ref_kf[order], -1),
        pt_found=pg(m.pt_found), pt_visible=pg(m.pt_visible),
        pt_first_frame=jnp.where(kept, m.pt_first_frame[order], -1),
        pt_valid=kept & m.pt_valid[order],
        pt_desc_hist=pg(m.pt_desc_hist), pt_desc_n=pg(m.pt_desc_n),
        obs_kf=og(m.obs_kf, -1), obs_pt=og(new_pt, -1),
        obs_uv=og(m.obs_uv, 0.0), obs_octave=og(m.obs_octave, 0),
        obs_ur=og(m.obs_ur, -1.0),
        obs_valid=okept,
        n_pt=n_valid, n_obs=n_ov,
        pt_kf_mask=pg(m.pt_kf_mask),
    ), remap


def cull_points(m: MapState, current_frame_id, min_found_ratio: float = 0.25,
                min_obs: int = 3, window: int = 90) -> MapState:
    """MapPointCulling parity (reference src/LocalMapping.cc:371-410):
    recent points must keep found/visible >= 0.25 and reach >= min_obs
    observations within ~2-3 KFs of creation (approximated by a frame-id
    window since KF cadence is variable)."""
    age = current_frame_id - m.pt_first_frame
    ratio = m.pt_found.astype(jnp.float32) / \
        jnp.maximum(m.pt_visible.astype(jnp.float32), 1.0)
    nobs = point_obs_count(m)
    bad = (ratio < min_found_ratio) | ((age > window) & (nobs < min_obs))
    keep = m.pt_valid & ~(bad & (age <= 3 * window))
    # points older than 3*window that survived are kept permanently
    return m._replace(pt_valid=keep)
