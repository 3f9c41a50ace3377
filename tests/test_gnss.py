"""GNSS geo-referencing end-to-end (the fork's headline feature).

Parity targets: GeometricReferencer (reference
src/GeometricReferencer.cpp:119-166 — sliding-window Umeyama init +
windowed updates), LocalGNSSBundleAdjustment (src/Optimizer.cc:1362-1604
— GNSS position priors in BA), and the WGS84->EPSG3857 conversion
(ros2_ws include/conversions.hpp).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from orbslam3_tpu.geometry import georef as georef_mod
from orbslam3_tpu.pipeline import system as base_sys
from test_pipeline_e2e import HW, K4, SyntheticWorld, camera_path


def test_wgs84_to_epsg3857_roundtrip_scale():
    # equator: 1 deg lon ~ 111.3 km in web mercator
    x0, _ = georef_mod.wgs84_to_epsg3857(np.array(0.0), np.array(8.0))
    x1, _ = georef_mod.wgs84_to_epsg3857(np.array(0.0), np.array(9.0))
    assert abs((x1 - x0) - 111319.49) < 1.0


class TestGnssEndToEnd:
    def test_georef_init_and_gnss_ba(self):
        """Mono drive feeding GNSS fixes: the Umeyama georeference must
        initialize, trajectory_geo() must land on the true geo track, and
        the GNSS-prior BA must keep running (finite poses, no reset)."""
        world = SyntheticWorld(seed=4)
        n_frames = 80
        poses = camera_path(n_frames)
        cfg = base_sys.SlamConfig(
            cam_params=K4, image_hw=HW, max_frames_between_kf=5,
            ba_caps=(24, 4096, 16384),
            enable_gnss=True, gnss_min_kfs=6, gnss_ba_every=2,
            gnss_sigma=0.05, gnss_time_tol=0.03)
        sys_ = base_sys.System(cfg)

        # true geo frame = scaled/rotated/offset SLAM world (like EPSG3857
        # around an origin); fixes carry noise
        th = 0.8
        R_geo = np.array([[np.cos(th), -np.sin(th), 0],
                          [np.sin(th), np.cos(th), 0],
                          [0, 0, 1.0]])
        s_geo = 7.0
        t_geo = np.array([4.5e6, 1.1e6, 320.0])   # large offset (f64 path)
        rng = np.random.default_rng(2)

        gt_geo = []
        for i, pose in enumerate(poses):
            R_cw, t_cw = pose[0], pose[1]
            ts = i * 0.05
            twc = -np.asarray(R_cw).T @ np.asarray(t_cw)
            geo = s_geo * (R_geo @ twc) + t_geo
            gt_geo.append(geo)
            sys_.grab_gnss(ts, geo + rng.normal(0, 0.02, 3))
            ff = world.frame(R_cw, t_cw)
            sys_.track_monocular(None, ts=ts, features=ff)

        assert sys_.n_resets == 0
        assert sys_.georef.initialized, "georeference never initialized"
        # Mono init normalizes the map scale, so the Sim3's scale absorbs
        # an arbitrary map-unit factor — only positivity/finiteness is a
        # contract; accuracy is asserted on the geo-frame trajectory below.
        est_s = float(sys_.georef.transform.s)
        assert np.isfinite(est_s) and est_s > 0.0, est_s
        geo_traj = sys_.trajectory_geo()
        ts_used = [p[0] for p in sys_.trajectory]
        gt_used = np.stack([gt_geo[int(round(t / 0.05))] for t in ts_used])
        err = np.linalg.norm(geo_traj - gt_used, axis=1)
        # geo-frame RMSE well under one geo unit (fixes had sigma 0.02)
        assert float(np.sqrt((err ** 2).mean())) < 0.5, err.mean()
        assert bool(jnp.all(jnp.isfinite(sys_.map.kf_t[:int(
            sys_.map.n_kf)])))


class TestGeorefSurvivesReanchor:
    def test_world_sim3_transforms_the_umeyama_window(self):
        """IMU-init re-anchoring applies a world Sim3 to the map; the
        georeference's sliding window of SLAM positions must ride the
        same Sim3 or the Umeyama fit mixes frames (regression: a 7x
        re-anchor left the SLAM->geo scale at 2.1 instead of 3.0 and
        the geo error at ~0.8 m in an earlier drive)."""
        from orbslam3_tpu.pipeline import inertial_system
        from orbslam3_tpu.pipeline import system as base_sys
        from orbslam3_tpu.ops import lie

        cfg = base_sys.SlamConfig(
            cam_params=K4, image_hw=HW, enable_gnss=True, gnss_min_kfs=6)
        icfg = inertial_system.InertialConfig(imu_freq=200.0)
        sys_ = inertial_system.InertialSystem(cfg, icfg)

        rng = np.random.default_rng(0)
        s_geo, t_geo = 3.0, np.array([100.0, -50.0, 10.0])
        Rgeo = np.asarray(lie.exp_so3(jnp.asarray([0.0, 0.0, 0.6])))
        # pre-anchor SLAM frame is 1/7 metric
        pts_metric = rng.normal(0, 2.0, (8, 3))
        for p in pts_metric:
            sys_.georef.add_fix((p / 7.0).astype(np.float32),
                                (s_geo * (Rgeo @ p) + t_geo).astype(
                                    np.float32))
        # IMU init re-anchors the world: x' = 7 * Rg x
        Rg = np.asarray(lie.exp_so3(jnp.asarray([0.05, -0.1, 0.3])))
        sys_.georef.update()
        sys_._apply_world_sim3(jnp.asarray(Rg, jnp.float32), 7.0)
        tr = sys_.georef.transform
        assert tr is not None
        # the refreshed transform must map POST-anchor SLAM coords
        # (metric, Rg-rotated) onto the geo frame
        np.testing.assert_allclose(float(tr.s), s_geo / 1.0, rtol=1e-3)
        p_new = (7.0 * Rg @ (pts_metric[0] / 7.0)).astype(np.float32)
        geo = np.asarray(tr.s * np.asarray(tr.R) @ p_new + np.asarray(tr.t))
        np.testing.assert_allclose(
            geo, s_geo * (Rgeo @ pts_metric[0]) + t_geo, atol=1e-2)
