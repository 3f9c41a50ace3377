"""GNSS geo-referencing: align the SLAM trajectory to GNSS fixes.

Parity target: the fork's GeometricReferencer
(/root/reference/src/GeometricReferencer.cpp:119-166): maintain a sliding
window of keyframes with GNSS fixes; estimate the Sim3 (Umeyama with
scale) mapping SLAM positions to the GNSS frame (EPSG3857 planar coords,
reference ros2_ws include/conversions.hpp); initialization after
`min_kfs` fixes, then windowed updates; apply() transforms SLAM poses
into the geo frame.  The GNSS-constrained BA
(Optimizer::LocalGNSSBundleAdjustment, src/Optimizer.cc:1362) is realized
here as position-prior residuals added to the standard BA problem.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..ops import align

WGS84_A = 6378137.0


def wgs84_to_epsg3857(lat_deg: np.ndarray, lon_deg: np.ndarray):
    """Web-mercator conversion (reference include/epsg3857.hpp)."""
    x = WGS84_A * np.radians(lon_deg)
    y = WGS84_A * np.log(np.tan(np.pi / 4 + np.radians(lat_deg) / 2))
    return x, y


class GeorefTransform(NamedTuple):
    R: jnp.ndarray   # (3,3)
    t: jnp.ndarray   # (3,)
    s: jnp.ndarray   # ()
    valid: bool


@dataclasses.dataclass
class GeometricReferencer:
    """Sliding-window Umeyama alignment SLAM -> GNSS frame."""
    min_kfs: int = 10
    window: int = 50
    # degenerate-geometry guard: minimum positional spread (std-norm) of
    # the SLAM positions before estimating the Sim3.  In SLAM units —
    # mono maps are median-depth normalized, so this must be small.
    min_spread: float = 0.1
    _slam: list = dataclasses.field(default_factory=list)
    _gnss: list = dataclasses.field(default_factory=list)
    transform: GeorefTransform | None = None

    def add_fix(self, slam_pos, gnss_pos):
        self._slam.append(np.asarray(slam_pos, np.float32))
        self._gnss.append(np.asarray(gnss_pos, np.float32))
        if len(self._slam) > self.window:
            self._slam.pop(0)
            self._gnss.pop(0)

    @property
    def initialized(self) -> bool:
        return self.transform is not None

    def update(self) -> GeorefTransform | None:
        """Re-estimate the Sim3 if enough fixes are buffered."""
        if len(self._slam) < self.min_kfs:
            return self.transform
        src = jnp.asarray(np.stack(self._slam))
        dst = jnp.asarray(np.stack(self._gnss))
        # degenerate-geometry guard: reference requires sufficient spread
        spread = float(jnp.linalg.norm(jnp.std(src, axis=0)))
        if spread < self.min_spread:
            return self.transform
        R, t, s = align.umeyama_alignment(src, dst, with_scale=True)
        self.transform = GeorefTransform(R=R, t=t, s=s, valid=True)
        return self.transform

    def apply(self, xyz: jnp.ndarray) -> jnp.ndarray:
        """SLAM coords -> geo frame (reference GeometricReferencer::apply)."""
        if self.transform is None:
            return xyz
        T = self.transform
        return T.s * xyz @ T.R.T + T.t


def gnss_position_residuals(pwb: jnp.ndarray, gnss: jnp.ndarray,
                            has_fix: jnp.ndarray,
                            sigma: float = 1.0) -> jnp.ndarray:
    """(K,3) weighted position residuals for GNSS-constrained BA
    (the analogue of the fork's LocalGNSSBundleAdjustment edges:
    unary priors on keyframe positions in the geo frame)."""
    w = has_fix.astype(jnp.float32)[:, None] / sigma
    return (pwb - gnss) * w
