"""ORB extraction on the card: the Pallas orientation + descriptor kernel
against the plain-XLA version, end to end and alone.

At EuRoC shape (752x480, 1200 features, 8 levels) on rendered frames:
  * `extract_jit` (kernel) and the same pipeline with
    `extractor.describe_xla`, alternated kernel/XLA/XLA/kernel, each call
    timed with `block_until_ready`, median and p90 over fresh frames;
  * the describe step alone, both ways, on the atlases `detect` produced;
  * agreement of the kernel's FeatureFrame with the XLA one on the card
    and with the CPU's (`eval.parity` bounds);
  * a profiler trace of a few calls of each, device time summed by the
    `orb_*` named scope found in each kernel's metadata.

Usage: python tools/drives/drive_extract_bench.py [n_frames]
Prints the result as one JSON line (traces stay in the system temp
directory).
"""
import glob
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np

SCOPES = ("orb_pyramid", "orb_select", "orb_angle", "orb_brief",
          "orb_describe")


def median_ms(fn, inputs):
    import jax
    ts = []
    for x in inputs:
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*x))
        ts.append(time.perf_counter() - t0)
    return [1e3 * float(np.median(ts)), 1e3 * float(np.percentile(ts, 90))]


def scope_times(trace_dir: str, n_calls: int) -> dict:
    """Device time (ms per call) per orb_* scope and in total, for each
    kind of device trace line (kernel streams, XLA ops, XLA modules), so
    no interval is counted twice."""
    from jax.profiler import ProfileData
    tot = defaultdict(float)
    (path,) = glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True)
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            kind = line.name.split("#")[0].split("(")[0].strip()
            for ev in line.events:
                text = ev.name + " " + " ".join(
                    f"{k}={v}" for k, v in ev.stats)
                scope = next((s for s in SCOPES if s in text), "other")
                tot[f"{kind}/total"] += ev.duration_ns / 1e6 / n_calls
                tot[f"{kind}/{scope}"] += ev.duration_ns / 1e6 / n_calls
    return dict(tot)


def main():
    import jax
    import jax.numpy as jnp

    from orbslam3_tpu import config
    from orbslam3_tpu.eval import parity, scenes
    from orbslam3_tpu.features import extractor

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"{jax.devices()} [{card}]", flush=True)
    cfg = config.euroc_mono()
    p = cfg.orb
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 50
    scene = scenes.Scene(cfg, seed=3)
    host_frames = [scene.render(i / 20.0) for i in range(n)]
    frames = [jnp.asarray(f) for f in host_frames]
    jax.block_until_ready(frames)

    @jax.jit
    def extract_xla(img):
        atlas, blur, xy_a, xy, resp, octave, valid = extractor.detect(img, p)
        angle, desc = extractor.describe_xla(atlas, blur, xy_a)
        return extractor.FeatureFrame(xy, resp, octave, angle, desc, valid)

    def extract_kernel(img):
        return extractor.extract_jit(img, p)

    detect = jax.jit(extractor.detect, static_argnums=1)
    describe = jax.jit(extractor.describe)
    describe_xla = jax.jit(extractor.describe_xla)
    res = dict(card=card, device_kind=jax.devices()[0].device_kind,
               n_frames=n)
    for name, fn in (("kernel", extract_kernel), ("xla", extract_xla)):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(frames[0]))
        res[f"compile_s_{name}"] = time.perf_counter() - t0
        print(f"extract ({name}) compile + first call: "
              f"{res[f'compile_s_{name}']:.3f} s [{card}]", flush=True)

    # agreement: kernel vs XLA on the card, kernel on the card vs the CPU
    cpu = jax.devices("cpu")[0]
    ff_k = extract_kernel(frames[0])
    res["agree_kernel_vs_xla_card"] = parity.feature_frame_agreement(
        ff_k, extract_xla(frames[0]))
    res["agree_kernel_vs_cpu"] = parity.compare_extractor(
        host_frames[0], p, jax.devices()[0], cpu)
    print(json.dumps({k: v for k, v in res.items()
                      if k.startswith("agree")}), flush=True)

    parts = [detect(f, p)[:3] for f in frames]
    jax.block_until_ready((describe(*parts[0]), describe_xla(*parts[0])))
    one = [(f,) for f in frames]
    for rnd, order in enumerate((("kernel", "xla"), ("xla", "kernel"))):
        for name in order:
            ext = extract_kernel if name == "kernel" else extract_xla
            des = describe if name == "kernel" else describe_xla
            res[f"extract_ms_{name}_r{rnd}"] = median_ms(ext, one)
            res[f"describe_ms_{name}_r{rnd}"] = median_ms(des, parts)

    tmp = tempfile.mkdtemp()
    for name, fn in (("kernel", extract_kernel), ("xla", extract_xla)):
        d = os.path.join(tmp, name)
        with jax.profiler.trace(d):
            for f in frames[:10]:
                jax.block_until_ready(fn(f))
        res[f"trace_ms_by_scope_{name}"] = scope_times(d, 10)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
