"""Smoke run of the SLAM engine on NVIDIA GPUs, end to end.

One card (default):
  * EuRoC monocular (`config.euroc_mono`, 752x480, 1200 features, 8
    levels, default map capacity) and EuRoC monocular-inertial
    (`config.euroc_mono_inertial`, IMU at 200 Hz) fly over a rendered
    textured world made from a seed; every frame goes in as pixels through
    `track_monocular`.  Each run must pass its accuracy gate.
  * The extractor and the solvers (window BA, VI window BA with dense and
    PCG reduced solves, pose-only and VI pose optimization, 512-row
    preintegration) run on the card and on the CPU of this process, and
    must agree within the bounds of `orbslam3_tpu.eval.parity`.

`--cards 4`: only the sharded window BA (`SlamConfig.ba_mesh_shards=4`
through `mapping.run_local_ba`, and each `dist_ba` communication mode)
against the same solve on one card.

Usage (from the repository root; one JAX process per card):
    python chip_smoke.py [--cards 4]

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform", "kind", "count"}}; any failure exits
non-zero without it.  With no GPU visible the script fails at once.
"""

import argparse
import json
import subprocess
import sys
import time

MONO_FRAMES = 120      # 6 s at 20 Hz
INERTIAL_FRAMES = 260  # 13 s at 20 Hz: IMU init, then its first refinement


def card_name_and_limit() -> str:
    """nvidia-smi's name and power limit, one line per card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    args = ap.parse_args()

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX sees {devs}", file=sys.stderr)
        return 1
    if len(devs) < args.cards:
        print(f"--cards {args.cards} but JAX sees {len(devs)} GPUs",
              file=sys.stderr)
        return 1
    card = card_name_and_limit()
    print(card, flush=True)
    print(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}",
          flush=True)

    from orbslam3_tpu import config
    from orbslam3_tpu.eval import smoke
    from orbslam3_tpu.slam_map import state as mapstate

    log = smoke.Log("; ".join(card.splitlines()))
    t0 = time.perf_counter()
    if args.cards == 4:
        failures: list = []
        smoke.sharded_phase(devs[:4], config.euroc_mono(
            map_capacity=mapstate.MapCapacity(
                n_kf=16, n_pt=4096, n_obs=12288)), log, failures)
    else:
        failures = smoke.one_device(
            devs[0], jax.devices("cpu")[0], config.euroc_mono(),
            *config.euroc_mono_inertial(), MONO_FRAMES, INERTIAL_FRAMES,
            log)
    log.time("total", t0)
    if failures:
        for f in failures:
            print("FAIL:", f, file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
