"""Atlas: multi-map container with map creation on tracking loss and
Sim3-based map merging.

Parity target: reference Atlas (include/Atlas.h:42-128, src/Atlas.cc:47
CreateNewMap — stores the current map and re-bases ids) and upstream's
map-merge machinery (welding two maps after a cross-map place-recognition
hit; the merge BA is the standard local BA over the welded region).

Design: each session map is an immutable MapState pytree; merging is
array concatenation into a fresh fixed-capacity state after transforming
the newer map with the measured Sim3 (x_old = s Rg x_new + tg).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp

from ..ops import lie
from . import state as mapstate

_HI = None  # precision handled inside lie ops


@dataclasses.dataclass
class MapSession:
    """One stored SLAM session (a 'Map' in the reference Atlas)."""
    map: mapstate.MapState
    kf_features: dict
    kf_bindings: dict
    trajectory: list
    db: object = None   # archived place-recognition KeyframeDB
    kf_ur: dict = None  # kf_idx -> stereo right-u rows (stereo/RGBD)


@dataclasses.dataclass
class Atlas:
    capacity: mapstate.MapCapacity
    sessions: list = dataclasses.field(default_factory=list)

    def store_session(self, m, kf_features, kf_bindings, trajectory,
                      db=None, kf_ur=None):
        """Archive the current map (reference CreateNewMap keeps old maps)."""
        if int(m.n_kf) >= 2:
            self.sessions.append(MapSession(
                map=m, kf_features=dict(kf_features),
                kf_bindings=dict(kf_bindings), trajectory=list(trajectory),
                db=db, kf_ur=dict(kf_ur) if kf_ur else None))

    @property
    def n_maps(self) -> int:
        return len(self.sessions)


def transform_map(m: mapstate.MapState, Rg, tg, s) -> mapstate.MapState:
    """Apply the world Sim3 x' = s Rg x + tg to every KF/point.

    Camera poses: R' = R Rg^T, t' = s t - R Rg^T tg (keeps projection
    consistent up to the global scale)."""
    kf_R = jnp.einsum("kij,lj->kil", m.kf_R, Rg)
    kf_t = s * m.kf_t - jnp.einsum("kij,j->ki", kf_R, tg)
    pt = s * jnp.einsum("ij,kj->ki", Rg, m.pt_xyz) + tg
    vel = s * jnp.einsum("ij,kj->ki", Rg, m.kf_vel)
    nrm = jnp.einsum("ij,kj->ki", Rg, m.pt_normal)
    return m._replace(kf_R=kf_R, kf_t=kf_t, pt_xyz=pt, kf_vel=vel,
                      pt_normal=nrm,
                      pt_min_dist=m.pt_min_dist * s,
                      pt_max_dist=m.pt_max_dist * s)


def merge_maps(m_old: mapstate.MapState, m_new: mapstate.MapState,
               Rg, tg, s, cap: mapstate.MapCapacity
               ) -> tuple[Optional[mapstate.MapState], int, int]:
    """Weld m_new into m_old's frame (x_old = s Rg x_new + tg).

    Returns (merged map, kf_offset, pt_offset) — new-map indices shift by
    the offsets — or (None, 0, 0) if capacities would overflow.
    """
    nk_o, np_o, no_o = int(m_old.n_kf), int(m_old.n_pt), int(m_old.n_obs)
    nk_n, np_n, no_n = int(m_new.n_kf), int(m_new.n_pt), int(m_new.n_obs)
    if nk_o + nk_n > cap.n_kf or np_o + np_n > cap.n_pt or \
            no_o + no_n > cap.n_obs:
        return None, 0, 0
    t = transform_map(m_new, Rg, tg, s)

    def splice(a, b, n_a, n_b):
        return a.at[n_a:n_a + n_b].set(b[:n_b])

    m = m_old
    m = m._replace(
        kf_R=splice(m.kf_R, t.kf_R, nk_o, nk_n),
        kf_t=splice(m.kf_t, t.kf_t, nk_o, nk_n),
        kf_vel=splice(m.kf_vel, t.kf_vel, nk_o, nk_n),
        kf_bias=splice(m.kf_bias, t.kf_bias, nk_o, nk_n),
        kf_ts=splice(m.kf_ts, t.kf_ts, nk_o, nk_n),
        kf_frame_id=splice(m.kf_frame_id, t.kf_frame_id, nk_o, nk_n),
        kf_valid=splice(m.kf_valid, t.kf_valid, nk_o, nk_n),
        pt_xyz=splice(m.pt_xyz, t.pt_xyz, np_o, np_n),
        pt_desc=splice(m.pt_desc, t.pt_desc, np_o, np_n),
        pt_normal=splice(m.pt_normal, t.pt_normal, np_o, np_n),
        pt_min_dist=splice(m.pt_min_dist, t.pt_min_dist, np_o, np_n),
        pt_max_dist=splice(m.pt_max_dist, t.pt_max_dist, np_o, np_n),
        pt_ref_kf=splice(m.pt_ref_kf, t.pt_ref_kf + nk_o, np_o, np_n),
        pt_found=splice(m.pt_found, t.pt_found, np_o, np_n),
        pt_visible=splice(m.pt_visible, t.pt_visible, np_o, np_n),
        pt_first_frame=splice(m.pt_first_frame, t.pt_first_frame,
                              np_o, np_n),
        pt_valid=splice(m.pt_valid, t.pt_valid, np_o, np_n),
        obs_kf=splice(m.obs_kf, t.obs_kf + nk_o, no_o, no_n),
        obs_pt=splice(m.obs_pt, t.obs_pt + np_o, no_o, no_n),
        obs_uv=splice(m.obs_uv, t.obs_uv, no_o, no_n),
        obs_octave=splice(m.obs_octave, t.obs_octave, no_o, no_n),
        obs_ur=splice(m.obs_ur, t.obs_ur, no_o, no_n),
        obs_valid=splice(m.obs_valid, t.obs_valid, no_o, no_n),
        pt_desc_hist=splice(m.pt_desc_hist, t.pt_desc_hist, np_o, np_n),
        pt_desc_n=splice(m.pt_desc_n, t.pt_desc_n, np_o, np_n),
        n_kf=jnp.asarray(nk_o + nk_n, jnp.int32),
        n_pt=jnp.asarray(np_o + np_n, jnp.int32),
        n_obs=jnp.asarray(no_o + no_n, jnp.int32),
    )
    # persistent loop edges of the incoming map ride along with shifted
    # keyframe indices (reference merge keeps every KF's mspLoopEdges)
    nl_o, nl_n = int(m_old.n_loop), int(m_new.n_loop)
    if nl_n and nl_o + nl_n <= m.loop_i.shape[0]:
        m = m._replace(
            loop_i=splice(m.loop_i, m_new.loop_i + nk_o, nl_o, nl_n),
            loop_j=splice(m.loop_j, m_new.loop_j + nk_o, nl_o, nl_n),
            loop_R=splice(m.loop_R, m_new.loop_R, nl_o, nl_n),
            # camera-frame relative translations rescale with the global
            # weld scale (x_cam' = s x_cam under transform_map)
            loop_t=splice(m.loop_t, m_new.loop_t * s, nl_o, nl_n),
            loop_s=splice(m.loop_s, m_new.loop_s, nl_o, nl_n),
            loop_valid=splice(m.loop_valid, m_new.loop_valid, nl_o, nl_n),
            n_loop=jnp.asarray(nl_o + nl_n, jnp.int32),
        )
    # splice bypassed add_observations: recompute the incidence grid
    m = mapstate.rebuild_incidence(m)
    return m, nk_o, np_o
