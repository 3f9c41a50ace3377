"""Rendered synthetic flights driven through the production System classes.

A look-down camera flies over the textured ground plane and mesas of
`utils/synth_render`.  Images are rendered from a seed at the
configuration's own resolution and intrinsics, and the inertial flight
synthesizes the body's IMU stream (camera-to-body extrinsic included) from
the same analytic path.  Every frame goes in as pixels through
`track_monocular(img, ts)`, so the route runs `System._extract`.
"""

from __future__ import annotations

import dataclasses
import time

import jax.numpy as jnp
import numpy as np

from ..ops import align
from ..pipeline import inertial_system, system as base_sys
from ..utils import synth_render as sr

GRAVITY = np.array([0.0, 0.0, -9.81])


@dataclasses.dataclass(frozen=True)
class Flight:
    """Analytic camera path over the plane: forward at `speed` m/s with a
    lateral weave, a vertical bob (accelerometer excitation) and yaw/tilt
    wobble (gyro excitation)."""
    speed: float = 0.6
    altitude: float = 5.0
    bob: float = 0.35

    def camera(self, t: float):
        """(R_cw, t_cw) at time t."""
        return sr.look_down_pose(
            self.speed * t, 0.05 * np.sin(1.7 * t),
            self.altitude + self.bob * np.sin(1.2 * t),
            yaw=0.04 * np.sin(t), tilt=0.03 * np.sin(1.3 * t))

    def camera_center(self, t: float) -> np.ndarray:
        R_cw, t_cw = self.camera(t)
        return -(R_cw.T.astype(np.float64) @ t_cw)

    def body(self, t: float, Tbc: np.ndarray):
        """(Rwb, pwb) of the body carrying the camera (x_b = Tbc x_c)."""
        R_cw, t_cw = self.camera(t)
        Rwc = R_cw.T.astype(np.float64)
        twc = -(Rwc @ t_cw)
        Tcb = np.linalg.inv(Tbc)
        return Rwc @ Tcb[:3, :3], twc + Rwc @ Tcb[:3, 3]

    def imu(self, t: float, Tbc: np.ndarray, h: float = 1e-3):
        """Noise-free (gyro, acc) in the body frame at time t, by central
        differences of the analytic path."""
        p = [self.body(t + k * h, Tbc)[1] for k in (-1, 0, 1)]
        a_w = (p[2] - 2.0 * p[1] + p[0]) / (h * h)
        R0 = self.body(t, Tbc)[0]
        dR = R0.T @ self.body(t + h, Tbc)[0]
        w = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0],
                      dR[1, 0] - dR[0, 1]]) * 0.5 / h
        return w.astype(np.float32), (R0.T @ (a_w - GRAVITY)).astype(
            np.float32)


class Scene:
    """Textured world + renderer for one camera configuration."""

    def __init__(self, cfg: base_sys.SlamConfig, seed: int,
                 flight: Flight = Flight(), noise: float = 1.5):
        self.cfg = cfg
        self.flight = flight
        self.noise = noise
        self.rng = np.random.default_rng(seed)
        self.texture = sr.block_texture(self.rng, block=10)
        # texture pixels per metre, scaled with the focal length so a
        # reduced-resolution rehearsal sees the same world
        self.tex_scale = 60.0 * cfg.cam_params[0] / 458.654

    def render(self, t: float) -> np.ndarray:
        """(H, W) uint8 frame at time t."""
        R_cw, t_cw = self.flight.camera(t)
        img = sr.render_plane(R_cw, t_cw, np.asarray(self.cfg.cam_params),
                              self.cfg.image_hw, self.texture,
                              tex_scale=self.tex_scale)
        img += self.rng.normal(0, self.noise, img.shape).astype(np.float32)
        return np.clip(img, 0, 255).astype(np.uint8)


@dataclasses.dataclass
class RunResult:
    system: base_sys.System
    ate: float           # scale-aligned RMSE (see run_* for the span)
    span: float          # extent of the evaluated ground-truth path
    scale: float         # alignment scale (metric maps: ~1)
    n_kf: int
    n_tracked: int
    n_frames: int
    last_frame: np.ndarray
    frame_s: list        # host wall of each track_monocular call

    def summary(self) -> dict:
        s = self.system
        tail = np.asarray(self.frame_s[len(self.frame_s) // 2:])
        out = dict(ate=self.ate, span=self.span, scale=self.scale,
                   n_kf=self.n_kf, n_tracked=self.n_tracked,
                   n_frames=self.n_frames, n_resets=s.n_resets,
                   state=s.state,
                   frame_ms_median_2nd_half=1e3 * float(np.median(tail)),
                   frame_ms_p90_2nd_half=1e3 * float(
                       np.percentile(tail, 90)))
        if isinstance(s, inertial_system.InertialSystem):
            out.update(imu_initialized=s.imu_initialized,
                       viba1_done=s.viba1_done)
        return out


def _evaluate(sys_, flight: Flight, frames_tail: float = 0.0):
    """Scale-aligned ATE of the recorded camera centres against the
    flight, over the trailing (1 - frames_tail) share of the trajectory."""
    est = np.stack([p[2] for p in sys_.trajectory])
    gt = np.stack([flight.camera_center(p[0]) for p in sys_.trajectory])
    lo = int(len(est) * frames_tail)
    rmse, s, _, _ = align.ate_rmse(jnp.asarray(est[lo:]),
                                   jnp.asarray(gt[lo:]), with_scale=True)
    span = float(np.linalg.norm(gt[lo:].max(0) - gt[lo:].min(0)))
    return float(rmse), span, float(s)


def run_mono(cfg: base_sys.SlamConfig, n_frames: int, seed: int = 3,
             fps: float = 20.0, flight: Flight = Flight()) -> RunResult:
    """Monocular flight through `System.track_monocular` with pixels.
    ATE is Sim3-aligned over the whole tracked trajectory."""
    scene = Scene(cfg, seed, flight)
    sys_ = base_sys.System(cfg)
    n_ok = 0
    img = None
    frame_s = []
    for i in range(n_frames):
        img = scene.render(i / fps)
        t0 = time.perf_counter()
        st, _ = sys_.track_monocular(img, ts=i / fps)
        frame_s.append(time.perf_counter() - t0)
        n_ok += st == base_sys.OK
    ate, span, s = _evaluate(sys_, flight)
    return RunResult(sys_, ate, span, s, sys_.n_kf_host, n_ok, n_frames,
                     img, frame_s)


def run_inertial(cfg: base_sys.SlamConfig,
                 icfg: inertial_system.InertialConfig, n_frames: int,
                 seed: int = 3, fps: float = 20.0,
                 flight: Flight = Flight()) -> RunResult:
    """Monocular-inertial flight: IMU samples at `icfg.imu_freq` through
    `grab_imu`, frames as pixels through `track_monocular`.  ATE is
    scale-aligned over the second half of the trajectory (after the
    staged IMU initialization has re-anchored the map)."""
    Tbc = (np.asarray(icfg.Tbc, np.float64).reshape(4, 4) if icfg.Tbc
           else np.eye(4))
    scene = Scene(cfg, seed, flight)
    sys_ = inertial_system.InertialSystem(cfg, icfg)
    dt_i = 1.0 / icfg.imu_freq
    n_ok = 0
    k = 1
    img = None
    frame_s = []
    for i in range(n_frames):
        t1 = i / fps
        while i > 0 and k * dt_i <= t1 + 1e-9:
            w, a = flight.imu(k * dt_i - 0.5 * dt_i, Tbc)
            sys_.grab_imu(k * dt_i, w, a)
            k += 1
        img = scene.render(t1)
        t0 = time.perf_counter()
        st, _ = sys_.track_monocular(img, ts=t1)
        frame_s.append(time.perf_counter() - t0)
        n_ok += st == base_sys.OK
    ate, span, s = _evaluate(sys_, flight, frames_tail=0.5)
    return RunResult(sys_, ate, span, s, sys_.n_kf_host, n_ok, n_frames,
                     img, frame_s)
