"""ORB feature extraction pipeline (pyramid -> FAST -> uniform select ->
IC-angle -> rBRIEF), one jit-compiled program per image shape.

Pipeline parity with the reference ORBextractor::extractFeatures
(src/ORBextractor.cc:543-586) with the substitutions documented in each op
module.  Two-threshold behavior: the reference retries FAST at
minThFAST when the iniThFAST detection found fewer than 75% of the FAST
candidate budget (src/ORBextractor.cc:455-470); here both tiers come from
one low-threshold score map and the low tier is masked in unless the high
tier is short — same decision, no second pass.

Output is a fixed-capacity FeatureFrame (SoA pytree) with a validity mask;
keypoint coordinates are in level-0 pixels (scaled by scale_factor^octave).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import brief, describe_kernel, fast, gridselect, image, orient


@dataclasses.dataclass(frozen=True)
class OrbParams:
    """Static extraction config (defaults = upstream EuRoC benchmark config,
    SURVEY §5.6: 1200 features, 8 levels, 1.2 scale, FAST 20/7)."""
    n_features: int = 1200
    n_levels: int = 8
    scale_factor: float = 1.2
    ini_th_fast: float = 20.0
    min_th_fast: float = 7.0
    border: int = 19          # upstream EDGE_THRESHOLD
    max_candidates: int = 2048  # per-level FAST candidate cap (level 0)

    def features_per_level(self) -> list[int]:
        """Geometric budget (src/ORBextractor.cc:113-124)."""
        f = 1.0 / self.scale_factor
        n_desired = self.n_features * (1 - f) / (1 - f ** self.n_levels)
        per = []
        total = 0
        for _ in range(self.n_levels - 1):
            per.append(int(round(n_desired)))
            total += per[-1]
            n_desired *= f
        per.append(max(self.n_features - total, 0))
        return per

    def scale_factors(self) -> np.ndarray:
        return self.scale_factor ** np.arange(self.n_levels, dtype=np.float32)

    def level_sigma2(self) -> np.ndarray:
        return self.scale_factors() ** 2

    @property
    def capacity(self) -> int:
        return sum(self.features_per_level())


class FeatureFrame(NamedTuple):
    """Fixed-capacity SoA keypoint set for one image."""
    xy: jnp.ndarray        # (N, 2) f32, level-0 pixel coords
    response: jnp.ndarray  # (N,) f32
    octave: jnp.ndarray    # (N,) int32
    angle: jnp.ndarray     # (N,) f32 degrees
    desc: jnp.ndarray      # (N, 8) uint32 packed 256-bit
    valid: jnp.ndarray     # (N,) bool

    @property
    def capacity(self) -> int:
        return self.xy.shape[0]


def _level_grid(budget: int, h: int, w: int) -> tuple[int, int]:
    """Grid with ~budget cells at the image aspect ratio."""
    rows = max(1, int(round(np.sqrt(budget * h / w))))
    cols = max(1, int(np.ceil(budget / rows)))
    return rows, cols


def _select_level(img_lv, budget: int, cand_cap: int, p: OrbParams):
    """FAST + candidate top-k + uniform selection for one pyramid level."""
    h, w = img_lv.shape
    score = fast.detect(img_lv, p.min_th_fast, border=max(p.border, 3))
    flat = score.reshape(-1)
    # blocked two-stage top-k: per-block top-8 instead of one full-image
    # sort (FAST corners after NMS are sparse; 8 winners per ~cap/8-pixel
    # strip loses nothing at a 3x candidate surplus, and the block cap is
    # itself a spatial-uniformity prior like the quadtree's)
    k_per = 8
    n_blocks = max(cand_cap // k_per, 1)
    pad = (-flat.shape[0]) % n_blocks
    blocks = jnp.pad(flat, (0, pad), constant_values=0.0).reshape(
        n_blocks, -1)
    bv, bi = jax.lax.top_k(blocks, k_per)               # (B, k)
    top_v = bv.reshape(-1)
    top_i = (bi + jnp.arange(n_blocks)[:, None] *
             blocks.shape[1]).reshape(-1)
    top_i = jnp.minimum(top_i, flat.shape[0] - 1)
    ys = (top_i // w).astype(jnp.float32)
    xs = (top_i % w).astype(jnp.float32)
    xy = jnp.stack([xs, ys], axis=-1)
    is_corner = top_v > 0
    is_high = top_v >= p.ini_th_fast

    # two-threshold gate (see module docstring)
    n_high = jnp.sum(is_high.astype(jnp.int32))
    use_low = n_high < jnp.int32(int(0.75 * 3 * budget))  # FAST budget ~3x kp budget
    valid = is_corner & (is_high | use_low)

    sel = gridselect.select_uniform(xy, top_v, valid, (h, w),
                                    _level_grid(budget, h, w), budget)
    ok = sel >= 0
    sel_c = jnp.maximum(sel, 0)
    return xy[sel_c], top_v[sel_c], ok


def detect(img: jnp.ndarray, p: OrbParams):
    """Pyramid + per-level FAST/selection.  Returns the packed pyramid
    atlases (all levels stacked vertically, raw and blurred), the selected
    keypoints in atlas coordinates, and the per-level-concatenated
    (xy level-0, response, octave, valid) outputs."""
    img = img.astype(jnp.float32)
    with jax.named_scope("orb_pyramid"):
        pyr, blurred = image.build_pyramid(img, p.n_levels, p.scale_factor)
    budgets = p.features_per_level()
    sf = p.scale_factors()
    w0 = pyr[0].shape[1]
    row_off = np.cumsum([0] + [q.shape[0] for q in pyr[:-1]]).tolist()

    xs_lv, rs, os_, vs, xs_atlas = [], [], [], [], []
    for lv in range(p.n_levels):
        area_ratio = (pyr[lv].shape[0] * pyr[lv].shape[1]) / (
            pyr[0].shape[0] * pyr[0].shape[1])
        cap = max(256, min(int(p.max_candidates * area_ratio),
                           pyr[lv].shape[0] * pyr[lv].shape[1]))
        with jax.named_scope(f"orb_select_l{lv}"):
            kxy, kresp, ok = _select_level(pyr[lv], budgets[lv], cap, p)
        xs_lv.append(kxy * sf[lv])  # level-0 coords for the output
        xs_atlas.append(kxy + jnp.asarray([0.0, row_off[lv]]))
        rs.append(kresp)
        os_.append(jnp.full(budgets[lv], lv, jnp.int32))
        vs.append(ok)

    def pack(levels):
        return jnp.concatenate(
            [jnp.pad(q, ((0, 0), (0, w0 - q.shape[1]))) for q in levels],
            axis=0)

    return (pack(pyr), pack(blurred), jnp.concatenate(xs_atlas),
            jnp.concatenate(xs_lv), jnp.concatenate(rs),
            jnp.concatenate(os_), jnp.concatenate(vs))


def describe_xla(atlas: jnp.ndarray, atlas_blur: jnp.ndarray,
                 xy_atlas: jnp.ndarray):
    """IC angle on the raw atlas and rBRIEF on the blurred one, one
    keypoint-centred window per keypoint (the reference's per-keypoint
    CUDA blocks become one batched window gather).  Plain XLA: the
    reference the Pallas kernel is checked against."""
    with jax.named_scope("orb_angle"):
        angle = orient.ic_angle(atlas, xy_atlas)
    with jax.named_scope("orb_brief"):
        desc = brief.compute_descriptors(atlas_blur, xy_atlas, angle)
    return angle, desc


def describe(atlas: jnp.ndarray, atlas_blur: jnp.ndarray,
             xy_atlas: jnp.ndarray):
    """(angle, desc) for keypoints at atlas coordinates.  Lowered for
    CUDA, the fused Pallas kernel (`ops/describe_kernel.py`); for every
    other platform, `describe_xla`.  The choice is made per lowering
    platform, so one jitted program serves both."""
    return jax.lax.platform_dependent(
        atlas, atlas_blur, xy_atlas, cuda=describe_kernel.describe,
        default=describe_xla)


def extract(img: jnp.ndarray, p: OrbParams) -> FeatureFrame:
    """img: (H, W) grayscale 0..255, u8 or f32.  Jit-able; one trace per
    (H, W).  Feed uint8 from the host — it is 4x cheaper to transfer and
    is cast on device.

    After per-level selection, orientation and descriptors run ONCE over a
    vertically packed pyramid atlas (all levels in one image) — one patch
    gather + one binned-BRIEF matmul stack for all keypoints instead of
    per-level kernel chains.  Patches stay level-local because the
    selection border (>= 19 px) covers both patch radii.
    """
    atlas, atlas_blur, xy_atlas, xy, response, octave, valid = detect(img, p)
    angle, desc = describe(atlas, atlas_blur, xy_atlas)
    return FeatureFrame(xy=xy, response=response, octave=octave,
                        angle=angle, desc=desc, valid=valid)


@functools.partial(jax.jit, static_argnums=1)
def extract_jit(img: jnp.ndarray, p: OrbParams) -> FeatureFrame:
    return extract(img, p)
