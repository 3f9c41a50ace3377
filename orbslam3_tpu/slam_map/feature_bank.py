"""Device-resident per-keyframe feature bank.

The reference keeps each KeyFrame's keypoints/descriptors in its object
(include/KeyFrame.h:231-240) and LocalMapping walks covisible neighbors'
feature sets on the CPU (SearchForTriangulation per neighbor,
src/LocalMapping.cc:488).  The equivalent here is one stacked array per
field so neighbor selection + multi-neighbor triangulation run inside a
single jitted program with gathers instead of host dict lookups.

The bank also mirrors the keypoint->map-point bindings (KeyFrame::
mvpMapPoints); the host-side dicts in System remain the API-facing store,
and every host write is mirrored here (see System._bank_* helpers).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..features.extractor import FeatureFrame


class FeatureBank(NamedTuple):
    xy: jnp.ndarray       # (K, N, 2) f32
    desc: jnp.ndarray     # (K, N, 8) uint32
    octave: jnp.ndarray   # (K, N) int32
    angle: jnp.ndarray    # (K, N) f32
    valid: jnp.ndarray    # (K, N) bool
    kp_pt: jnp.ndarray    # (K, N) int32 keypoint -> map point (-1 unbound)
    ur: jnp.ndarray       # (K, N) f32 stereo right-u (-1 = mono)


def empty_bank(n_kf: int, n_kp: int) -> FeatureBank:
    return FeatureBank(
        xy=jnp.zeros((n_kf, n_kp, 2), jnp.float32),
        desc=jnp.zeros((n_kf, n_kp, 8), jnp.uint32),
        octave=jnp.zeros((n_kf, n_kp), jnp.int32),
        angle=jnp.zeros((n_kf, n_kp), jnp.float32),
        valid=jnp.zeros((n_kf, n_kp), bool),
        kp_pt=jnp.full((n_kf, n_kp), -1, jnp.int32),
        ur=jnp.full((n_kf, n_kp), -1.0, jnp.float32),
    )


def set_frame(bank: FeatureBank, k, ff: FeatureFrame,
              kp_pt, ur=None) -> FeatureBank:
    """Write one keyframe's features + bindings at row k (k may be traced)."""
    if ur is None:
        ur = jnp.full(ff.xy.shape[0], -1.0, jnp.float32)
    return FeatureBank(
        xy=bank.xy.at[k].set(ff.xy),
        desc=bank.desc.at[k].set(ff.desc),
        octave=bank.octave.at[k].set(ff.octave),
        angle=bank.angle.at[k].set(ff.angle),
        valid=bank.valid.at[k].set(ff.valid),
        kp_pt=bank.kp_pt.at[k].set(kp_pt),
        ur=bank.ur.at[k].set(ur),
    )


def set_binding(bank: FeatureBank, k, kp_pt) -> FeatureBank:
    return bank._replace(kp_pt=bank.kp_pt.at[k].set(kp_pt))


def frame_view(bank: FeatureBank, k) -> FeatureFrame:
    """Gather one keyframe's features as a FeatureFrame (k may be traced)."""
    return FeatureFrame(
        xy=bank.xy[k], response=jnp.zeros(bank.xy.shape[1], jnp.float32),
        octave=bank.octave[k], angle=bank.angle[k], desc=bank.desc[k],
        valid=bank.valid[k])
