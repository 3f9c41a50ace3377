"""Relocalization: recover tracking after loss via place recognition.

Parity target: upstream Tracking::Relocalization (declared but deleted in
the fork — include/Tracking.h:169; the fork resets instead,
src/Tracking.cc:543) + KeyFrameDatabase::DetectRelocalizationCandidates
(src/KeyFrameDatabase.cc:731) + MLPnPsolver RANSAC
(src/MLPnPsolver.cpp; params at src/Tracking.cc:839).

Design: candidates from the TF-IDF database; every admitted
candidate (score >= 0.75 * bestScore, the reference's minScoreToRetain)
is evaluated in ONE batched program — descriptor matching + MLPnP
RANSAC vmapped over a fixed candidate cap, features gathered from the
device FeatureBank (no host feature staging) — and ONE host sync picks
the winner.  A host loop would instead dispatch one match + 2-3 syncs
PER candidate, serialized against the device at large DB sizes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import mlpnp
from ..ops import matching
from ..place import keyframe_db as kdb

RELOC_CANDS = 8      # fixed vmap width (reference retains a handful)


@functools.partial(jax.jit, static_argnames=("cam_model", "n_levels",
                                             "min_inliers"))
def _reloc_batch(m, bank, ff, cand_idx, cand_ok, key, cam_params,
                 cam_model: str, scale_factor, n_levels: int,
                 min_inliers: int):
    """Match + MLPnP-score all admitted candidates in parallel.

    Returns (success (C,), n_inliers (C,), R (C,3,3), t (C,3))."""
    P = m.pt_xyz.shape[0]
    K = bank.desc.shape[0]
    sf = scale_factor ** jnp.clip(ff.octave, 0,
                                  n_levels - 1).astype(jnp.float32)
    inv_s2 = 1.0 / (sf * sf)

    def per_cand(ci, ok, k):
        ci = jnp.clip(ci, 0, K - 1)
        c_desc = bank.desc[ci]
        c_valid = bank.valid[ci]
        c_kp_pt = bank.kp_pt[ci]
        c_angle = bank.angle[ci]
        mm = matching.match_nn(
            ff.desc, c_desc,
            mask=ff.valid[:, None] & c_valid[None, :] &
                 (c_kp_pt >= 0)[None, :],
            max_dist=matching.TH_LOW, nn_ratio=0.75,
            angles_a=ff.angle, angles_b=c_angle, check_rotation=True)
        n_matches = jnp.sum(mm.valid.astype(jnp.int32))
        pt_idx = jnp.clip(c_kp_pt[jnp.maximum(mm.idx, 0)], 0, P - 1)
        X = m.pt_xyz[pt_idx]
        # culling/fusion may have invalidated a bound point since the
        # candidate KF was inserted — never solve against dead points
        match_ok = mm.valid & m.pt_valid[pt_idx] & ok
        res = mlpnp.solve_mlpnp(
            X, ff.xy, match_ok, cam_model, cam_params, k,
            iterations=300, min_inliers=min_inliers, inv_sigma2=inv_s2)
        good = res.success & (n_matches >= 15) & ok
        return good, res.n_inliers, res.R, res.t

    keys = jax.random.split(key, cand_idx.shape[0])
    return jax.vmap(per_cand)(cand_idx, cand_ok, keys)


def attempt_relocalization(system, ff, loop_closer,
                           min_inliers: int = 30):
    """Try to relocalize `ff` against the keyframe database.

    Returns (success, R, t).  Mutates nothing.
    """
    m = system.map
    if system.bank is None:
        return False, None, None
    bow, _ = loop_closer._bow(ff.desc, ff.valid)
    scores, common = kdb.query(loop_closer.db, bow)
    scores_np = np.asarray(scores)          # sync 1: admission scores
    order_np = np.argsort(-scores_np)
    best = float(scores_np[order_np[0]])
    if best <= 0:
        return False, None, None
    # candidate admission: EVERY KF scoring >= 0.75 * bestScore
    # (reference DetectRelocalizationCandidates minScoreToRetain,
    # src/KeyFrameDatabase.cc:731) — with aliased places the true
    # candidate can sit well below rank 3.  Evaluated in batches of
    # RELOC_CANDS (best-scored first); one program + one decision sync
    # per batch, and almost every call needs exactly one batch.
    cand_list = [int(c) for c in order_np
                 if scores_np[c] >= 0.75 * best and
                 system.kf_bindings.get(int(c)) is not None]
    if not cand_list:
        return False, None, None
    C = RELOC_CANDS
    for lo in range(0, len(cand_list), C):
        batch = cand_list[lo:lo + C]
        cand_idx = np.zeros(C, np.int32)
        cand_ok = np.zeros(C, bool)
        cand_idx[:len(batch)] = batch
        cand_ok[:len(batch)] = True
        good, n_inl, R_all, t_all = _reloc_batch(
            m, system.bank, ff, jnp.asarray(cand_idx),
            jnp.asarray(cand_ok),
            jax.random.PRNGKey(system.frame_id + lo), system.cam_params,
            system.cfg.cam_model, system.cfg.orb.scale_factor,
            system.cfg.orb.n_levels, min_inliers)
        # the winner decision (one small pull for the whole batch)
        good_np, n_np = np.asarray(good), np.asarray(n_inl)
        if good_np.any():
            w = int(np.argmax(np.where(good_np, n_np, -1)))
            return True, R_all[w], t_all[w]
    return False, None, None
