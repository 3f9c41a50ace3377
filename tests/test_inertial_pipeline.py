"""Monocular-inertial end-to-end: synthetic world + IMU; after IMU init
the map must become metric (scale ~ 1 vs ground truth) and gravity-aligned.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orbslam3_tpu.ops import align, lie
from orbslam3_tpu.pipeline import inertial_system, system as base_sys
from test_pipeline_e2e import HW, K4, N_KP, SyntheticWorld

G = np.array([0.0, 0.0, -9.81])
FPS = 20.0
IMU_HZ = 200.0


def camera_path_smooth(n_frames):
    """Twc trajectory with real acceleration (for scale observability).
    Returns list of (R_cw, t_cw, twc, Rwc) plus analytic vel/acc."""
    dt = 1.0 / FPS

    def pos(t):
        return np.array([1.2 * np.sin(0.8 * t) + 0.6 * t,
                         0.8 * np.sin(1.1 * t + 1.0),
                         0.4 * np.sin(0.9 * t)])

    def vel(t):
        return np.array([1.2 * 0.8 * np.cos(0.8 * t) + 0.6,
                         0.8 * 1.1 * np.cos(1.1 * t + 1.0),
                         0.4 * 0.9 * np.cos(0.9 * t)])

    def acc(t):
        return np.array([-1.2 * 0.64 * np.sin(0.8 * t),
                         -0.8 * 1.21 * np.sin(1.1 * t + 1.0),
                         -0.4 * 0.81 * np.sin(0.9 * t)])

    def _rodrigues(w):
        """Pure-numpy SO3 exp (the jax version would sync the device
        once per IMU sample and dominate the drive wall time)."""
        th = np.linalg.norm(w)
        if th < 1e-10:
            return np.eye(3)
        k = w / th
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)

    def rot(t):  # gentle yaw
        return _rodrigues(np.array([0.0, 0.12 * np.sin(0.3 * t), 0.05 * t]))

    def rot_rate(t, eps=1e-4):
        R0, R1 = rot(t), rot(t + eps)
        dR = R0.T @ R1
        w = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0],
                      dR[1, 0] - dR[0, 1]]) * 0.5
        return w / eps

    frames = []
    for i in range(n_frames):
        t = i * dt
        Rwc = rot(t)
        twc = pos(t)
        R_cw = Rwc.T
        frames.append((R_cw.astype(np.float32),
                       (-R_cw @ twc).astype(np.float32), twc, Rwc))
    return frames, pos, vel, acc, rot, rot_rate


@pytest.mark.slow
class TestInertialPipeline:
    def test_imu_init_recovers_metric_scale(self):
        world = SyntheticWorld(seed=3)
        n_frames = 120
        frames, pos, vel, acc, rot, rot_rate = camera_path_smooth(n_frames)
        cfg = base_sys.SlamConfig(
            cam_params=K4, image_hw=HW, min_init_matches=80,
            max_frames_between_kf=6, ba_caps=(24, 4096, 16384))
        icfg = inertial_system.InertialConfig(
            imu_freq=IMU_HZ, init_time_s=1.5, init_min_kfs=5)
        sys_ = inertial_system.InertialSystem(cfg, icfg)

        dt_f = 1.0 / FPS
        dt_i = 1.0 / IMU_HZ
        for i in range(n_frames):
            t_frame = i * dt_f
            # IMU samples covering (t_frame - dt_f, t_frame]
            if i > 0:
                t0 = (i - 1) * dt_f
                k = 1
                while t0 + k * dt_i <= t_frame + 1e-9:
                    tm = t0 + k * dt_i
                    Rb = rot(tm - 0.5 * dt_i)  # camera == body here
                    a_body = Rb.T @ (acc(tm - 0.5 * dt_i) - G)
                    w_body = rot_rate(tm - 0.5 * dt_i)
                    sys_.grab_imu(tm, w_body, a_body)
                    k += 1
            R_cw, t_cw, twc, Rwc = frames[i]
            ff = world.frame(R_cw, t_cw)
            st, pose = sys_.track_monocular(None, ts=t_frame, features=ff)
        assert sys_.n_resets == 0, sys_.n_resets
        assert sys_.state == base_sys.OK
        assert sys_.imu_initialized, "IMU init never ran"
        # metric scale: align WITHOUT scale must be already decent
        est = np.stack([p[2] for p in sys_.trajectory])
        ts_used = [p[0] for p in sys_.trajectory]
        gt = np.stack([pos(t) for t in ts_used])
        # post-init part of trajectory only (after re-anchoring)
        n_half = len(est) // 2
        rmse_s, s, _, _ = align.ate_rmse(jnp.asarray(est[n_half:]),
                                         jnp.asarray(gt[n_half:]),
                                         with_scale=True)
        assert abs(float(s) - 1.0) < 0.12, \
            f"map scale not metric: alignment scale {float(s)}"
        assert float(rmse_s) < 0.1, float(rmse_s)
