"""The phases of `chip_smoke.py`, importable so the tests run them too.

Each phase takes the device under test and a reference device, prints one
line per result through `log`, and appends a message to `failures` for
every gate or bound it breaks.  `chip_smoke.py` runs them at EuRoC shapes
with the card against the CPU of the same process; the tests run them at
reduced shapes with two virtual CPU devices.
"""

from __future__ import annotations

import dataclasses
import time

import jax
import jax.numpy as jnp

from . import parity, scenes
from ..solver import vi_pose_opt

MONO_ATE_SPAN = 0.08   # Sim3-aligned ATE < 0.08 x path extent
INERTIAL_ATE = 0.1     # scale-aligned ATE [m] once the IMU is initialized
MIN_KEYFRAMES = 4


@dataclasses.dataclass
class Log:
    """Prints results; `tag` (the card's name and power limit) goes beside
    every time."""
    tag: str = ""

    def __call__(self, *parts) -> None:
        print(*parts, flush=True)

    def time(self, label: str, t0: float) -> None:
        self(f"{label}: {time.perf_counter() - t0:.3f} s [{self.tag}]")


def memory_line(compiled) -> str:
    ma = compiled.memory_analysis()
    return (f"args {ma.argument_size_in_bytes} B, outputs "
            f"{ma.output_size_in_bytes} B, temps {ma.temp_size_in_bytes} B, "
            f"code {ma.generated_code_size_in_bytes} B")


def mono_phase(cfg, n_frames: int, log: Log, failures: list):
    """Monocular flight with pixels; returns the RunResult."""
    t0 = time.perf_counter()
    run = scenes.run_mono(cfg, n_frames)
    log.time(f"mono {n_frames} frames (compile included)", t0)
    log("mono:", run.summary(), f"[{log.tag}]")
    s = run.system
    comp = s._track.lower(s.map, s.kf_features[s.last_kf_idx], s.R_cur,
                          s.t_cur, jnp.asarray(4.0, jnp.float32),
                          s.view).compile()
    log("mono tracked-frame program memory:", memory_line(comp))
    if not run.ate < MONO_ATE_SPAN * run.span:
        failures.append(f"mono ATE {run.ate} >= {MONO_ATE_SPAN} x span "
                        f"{run.span}")
    if run.n_kf < MIN_KEYFRAMES or s.n_resets:
        failures.append(f"mono: {run.n_kf} keyframes, {s.n_resets} resets")
    return run


def inertial_phase(cfg, icfg, n_frames: int, log: Log, failures: list):
    """Monocular-inertial flight with pixels and IMU; returns the
    RunResult."""
    t0 = time.perf_counter()
    run = scenes.run_inertial(cfg, icfg, n_frames)
    log.time(f"mono-inertial {n_frames} frames (compile included)", t0)
    log("mono-inertial:", run.summary(), f"[{log.tag}]")
    v = run.system
    packed = jnp.zeros((icfg.max_imu_per_frame *
                        (1 + icfg.preint_buf_factor), 8))
    prior = v.frame_prior or vi_pose_opt.VIPosePrior(
        Rwb=jnp.eye(3), pwb=jnp.zeros(3), vel=jnp.zeros(3),
        bias=jnp.zeros(6), H=jnp.eye(15))
    Rwb, pwb = v.last_body
    comp = v._vi_track_step.lower(
        v.map, v.view, v.kf_features[v.last_kf_idx], packed, prior,
        jnp.zeros(8), Rwb, pwb, v.vel, v.bias).compile()
    log("mono-inertial tracked-frame program memory:", memory_line(comp))
    if not (run.ate < INERTIAL_ATE and v.imu_initialized):
        failures.append(f"mono-inertial ATE {run.ate} (gate "
                        f"{INERTIAL_ATE}), imu_initialized "
                        f"{v.imu_initialized}")
    if run.n_kf < MIN_KEYFRAMES or v.n_resets:
        failures.append(f"mono-inertial: {run.n_kf} keyframes, "
                        f"{v.n_resets} resets")
    return run


def parity_phase(mono, inertial, dev, ref_dev, log: Log,
                 failures: list) -> None:
    """Extractor and solvers on `dev` against `ref_dev`, on the frames and
    map states the two flights left."""
    s, v = mono.system, inertial.system
    t0 = time.perf_counter()
    st = parity.compare_extractor(mono.last_frame, s.cfg.orb, dev, ref_dev)
    log.time("extractor parity", t0)
    log(f"extractor {s.cfg.image_hw} / {s.cfg.orb.n_features}:", st)
    failures += parity.feature_frame_failures(st)

    t0 = time.perf_counter()
    solvers = {**parity.compare_visual_solvers(s, dev, ref_dev),
               **parity.compare_inertial_solvers(v, dev, ref_dev)}
    log.time("solver parity", t0)
    for name, st in solvers.items():
        log(f"{name}:", st)
        failures += parity.pose_failures(name, st)
    st = parity.compare_preintegration(v, dev, ref_dev)
    log("preintegration 512 rows:", st)
    failures += parity.preintegration_failures(st)


def sharded_phase(devices, cfg, log: Log, failures: list) -> None:
    """Sharded window BA over `devices` against the one-device solve."""
    t0 = time.perf_counter()
    res = parity.compare_sharded_ba(devices, cfg)
    log.time(f"sharded BA over {len(devices)} devices vs one "
             "(compile included)", t0)
    for name, st in res.items():
        log(f"{name}:", st)
        failures += parity.pose_failures(name, st)
        if st.get("point_shards_on", len(devices)) != len(devices):
            failures.append(f"{name}: points sharded over "
                            f"{st['point_shards_on']} devices, not "
                            f"{len(devices)}")


def one_device(dev, ref_dev, mono_cfg, vi_cfg, icfg, mono_frames: int,
               vi_frames: int, log: Log) -> list:
    """Both flights on `dev` (the default device), then the parity phase
    against `ref_dev`.  Returns the failures."""
    failures: list = []
    with jax.default_device(dev):
        mono = mono_phase(mono_cfg, mono_frames, log, failures)
        vi = inertial_phase(vi_cfg, icfg, vi_frames, log, failures)
    parity_phase(mono, vi, dev, ref_dev, log, failures)
    return failures
