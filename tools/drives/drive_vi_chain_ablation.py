"""Diagnostic (on the card): inertial chain throughput ablation.

Localizes the throughput gap between the zero-sync INERTIAL chain and
the visual one by timing three dependent device chains on the SAME
warmed scene (scenario matches bench.bench_full_inertial; duplication is
deliberate — this is a diagnostic harness, the bench stays
self-contained):

  A. extract + track only          (visual-equivalent floor)
  B. A + frame preintegration + IMU predict (adds the 64-step scan)
  C. the production fused _vi_track_step    (adds retry cond + VI opt)

Run on the card:  python tools/drives/drive_vi_chain_ablation.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp
    print("devices:", jax.devices(), flush=True)

    from orbslam3_tpu.features.extractor import OrbParams, extract_jit
    from orbslam3_tpu.ops import imu as imu_ops
    from orbslam3_tpu.pipeline import inertial_system, system as base_sys
    from orbslam3_tpu.pipeline import tracking as tracking_mod
    from orbslam3_tpu.utils import synth_render as sr

    HW = (480, 752)
    K4 = (400.0, 400.0, 376.0, 240.0)
    FPS, IMU_HZ = 10.0, 200.0
    G = np.array([0.0, 0.0, -9.81])
    rng = np.random.default_rng(7)
    tex = sr.block_texture(rng, block=10)
    p = OrbParams(n_features=1200, n_levels=8)
    cfg = base_sys.SlamConfig(
        cam_model="pinhole", cam_params=K4, image_hw=HW, orb=p,
        min_init_matches=60, min_track_inliers=20,
        max_frames_between_kf=6)
    icfg = inertial_system.InertialConfig(
        imu_freq=IMU_HZ, init_time_s=2.0, init_min_kfs=6,
        refine_time_s=5.0, refine2_time_s=1e9)
    sys_ = inertial_system.InertialSystem(cfg, icfg)

    def pose(t):
        x = 0.30 * t
        y = 0.05 * np.sin(1.7 * t)
        z = 5.0 + 0.35 * np.sin(1.2 * t)
        return sr.look_down_pose(x, y, z, yaw=0.04 * np.sin(t),
                                 tilt=0.03 * np.sin(1.3 * t))

    def pos_w(t):
        R_cw, t_cw = pose(t)
        return -(R_cw.T @ t_cw)

    def imu_at(t, h=1e-3):
        a_w = (pos_w(t + h) - 2.0 * pos_w(t) + pos_w(t - h)) / (h * h)
        R0 = pose(t)[0].T
        R1 = pose(t + h)[0].T
        dR = R0.T @ R1
        w = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0],
                      dR[1, 0] - dR[0, 1]]) * 0.5 / h
        return w.astype(np.float32), (R0.T @ (a_w - G)).astype(np.float32)

    def render(i):
        t = i / FPS
        R_cw, t_cw = pose(t)
        img = sr.render_plane(R_cw, t_cw, np.asarray(K4), HW, tex,
                              tex_scale=60.0)
        img += rng.normal(0, 1.5, img.shape).astype(np.float32)
        return np.clip(img, 0, 255).astype(np.uint8)

    warmup, measure = 80, 36
    frames = [render(i) for i in range(warmup + measure)]
    dt_i = 1.0 / IMU_HZ
    for i in range(warmup):
        t1 = i / FPS
        if i > 0:
            t0 = (i - 1) / FPS
            k = 1
            while t0 + k * dt_i <= t1 + 1e-9:
                tm = t0 + k * dt_i
                w, a = imu_at(tm - 0.5 * dt_i)
                sys_.grab_imu(tm, w, a)
                k += 1
        sys_.track_monocular(None, ts=t1,
                             features=extract_jit(jnp.asarray(frames[i]),
                                                  p))
    assert sys_.imu_initialized and sys_.state == base_sys.OK

    capF = icfg.max_imu_per_frame
    capK = capF * 16
    imu_all = []
    tcur = (warmup - 1) / FPS
    while tcur + dt_i <= (warmup + measure - 1) / FPS + 1e-9:
        tcur += dt_i
        w, a = imu_at(tcur - 0.5 * dt_i)
        imu_all.append((tcur, w, a))
    packed_dev, sc_dev = [], []
    for n, i in enumerate(range(warmup, warmup + measure)):
        t1, t0 = i / FPS, (i - 1) / FPS
        take = [s for s in imu_all if t0 < s[0] <= t1]
        steps = inertial_system.reference_imu_steps(take, t0, t1)
        packed = np.zeros((capF + capK, 8), np.float32)
        packed[:capF] = inertial_system.pack_imu_rows(steps, capF)
        packed_dev.append(jnp.asarray(packed))
        sc_dev.append(jnp.asarray(np.asarray(
            [4.0, cfg.min_track_inliers, 0.0, 1.0,
             max(sys_.last_kf_idx, 0), 0, 0, 0], np.float32)))
    dev_frames = [jnp.asarray(f) for f in frames[warmup:]]
    jax.block_until_ready(dev_frames[-1])

    cal = sys_.calib
    cam = jnp.asarray(K4, jnp.float32)

    @jax.jit
    def chain_a(m, view, img, R_prev, t_prev, R_cur, t_cur):
        from orbslam3_tpu.ops import lie
        ff = extract_jit(img, p)
        Rpi, tpi = lie.se3_inverse(R_prev, t_prev)
        Rv, tv = lie.se3_compose(R_cur, t_cur, Rpi, tpi)
        Rg, tg = lie.se3_compose(Rv, tv, R_cur, t_cur)
        tr = tracking_mod.track_local_map(
            m, ff, Rg, tg, "pinhole", cam, HW, p.scale_factor,
            p.n_levels, radius_th=jnp.asarray(4.0), view=view)
        m2 = tracking_mod.update_point_stats(m, tr)
        return m2, tr.R, tr.t

    @jax.jit
    def chain_b(m, view, img, packed, Rwb, pwb, vel, bias):
        ff = extract_jit(img, p)
        rowsF = packed[:capF]
        preF = imu_ops.preintegrate(rowsF[:, 0:3], rowsF[:, 3:6],
                                    rowsF[:, 6], rowsF[:, 7] > 0.5, cal,
                                    bias)
        R2, p2, v2 = imu_ops.predict_state(Rwb, pwb, vel, bias, preF)
        Rbw = R2.T
        tbw = -Rbw @ p2
        Rg = sys_.Rcb @ Rbw
        tg = sys_.Rcb @ tbw + sys_.tcb
        tr = tracking_mod.track_local_map(
            m, ff, Rg, tg, "pinhole", cam, HW, p.scale_factor,
            p.n_levels, radius_th=jnp.asarray(4.0), view=view)
        m2 = tracking_mod.update_point_stats(m, tr)
        Rwb2 = sys_.Rbc @ tr.R
        return m2, Rwb2.T, p2, v2

    @jax.jit
    def chain_c(m, view, img, packed, sc, prior, Rwb, pwb, vel, bias):
        ff = extract_jit(img, p)
        m2, out = sys_._vi_track_step(m, view, ff, packed, prior, sc,
                                      Rwb, pwb, vel, bias)
        return m2, out

    def timed(fn):
        # settle/compile
        fn(0, 6)
        jax.block_until_ready(state["sync"])
        t0 = time.perf_counter()
        fn(6, measure)
        jax.block_until_ready(state["sync"])
        return (measure - 6) / (time.perf_counter() - t0)

    from orbslam3_tpu.solver import vi_pose_opt as vpo
    m0, view0 = sys_.map, sys_.view
    Rwb0, pwb0 = sys_.last_body
    vel0, bias0 = sys_.vel, sys_.bias
    prior0 = sys_.frame_prior or vpo.VIPosePrior(
        Rwb=Rwb0, pwb=pwb0, vel=vel0, bias=bias0, H=jnp.eye(15))
    state = {}

    def run_a(lo, hi):
        m, R_prev, t_prev = m0, sys_.R_prev, sys_.t_prev
        R_cur, t_cur = sys_.R_cur, sys_.t_cur
        for n in range(lo, hi):
            m, R, t = chain_a(m, view0, dev_frames[n], R_prev, t_prev,
                              R_cur, t_cur)
            R_prev, t_prev, R_cur, t_cur = R_cur, t_cur, R, t
        state["sync"] = (R_cur, t_cur)

    def run_b(lo, hi):
        m, Rwb, pwb, vel = m0, Rwb0, pwb0, vel0
        for n in range(lo, hi):
            m, Rwb, pwb, vel = chain_b(m, view0, dev_frames[n],
                                       packed_dev[n], Rwb, pwb, vel,
                                       bias0)
        state["sync"] = (Rwb, pwb)

    def run_c(lo, hi):
        m, Rwb, pwb, vel, prior = m0, Rwb0, pwb0, vel0, prior0
        for n in range(lo, hi):
            m, out = chain_c(m, view0, dev_frames[n], packed_dev[n],
                             sc_dev[n], prior, Rwb, pwb, vel, bias0)
            Rwb, pwb, vel, prior = out.Rwb, out.pwb, out.vel, out.prior
        state["sync"] = (Rwb, pwb)

    fa = timed(run_a)
    fb = timed(run_b)
    fc = timed(run_c)
    print(f"\nA extract+track            : {fa:7.1f} fps "
          f"({1e3 / fa:6.2f} ms/frame)")
    print(f"B + preint(64) + predict   : {fb:7.1f} fps "
          f"({1e3 / fb:6.2f} ms/frame)")
    print(f"C fused _vi_track_step     : {fc:7.1f} fps "
          f"({1e3 / fc:6.2f} ms/frame)")
    print(f"preint+predict cost: {1e3 / fb - 1e3 / fa:6.2f} ms/frame; "
          f"retry-cond + VI opt cost: {1e3 / fc - 1e3 / fb:6.2f} ms/frame")


if __name__ == "__main__":
    main()
