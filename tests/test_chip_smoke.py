"""The card bring-up path, checked without a card.

* the extractor has one path for every backend;
* the cross-device comparison helpers of `eval.parity` accept equal
  results and reject perturbed ones;
* the smoke phases run end to end on two virtual CPU devices;
* `chip_smoke.py` refuses to run without a GPU, and alone;
* the compile cache follows JAX_COMPILATION_CACHE_DIR;
* a sharded BA asking for more devices than exist raises.

`gpu`-marked tests call the same phases on the card; the test
configuration pins the CPU, so they skip here and `chip_smoke.py` runs
them on the card.
"""
import json
import os
import shutil
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orbslam3_tpu import config
from orbslam3_tpu.eval import parity, smoke
from orbslam3_tpu.features import extractor
from orbslam3_tpu.features.extractor import FeatureFrame, OrbParams
from orbslam3_tpu.parallel import dist_ba
from orbslam3_tpu.pipeline import system as base_sys
from orbslam3_tpu.slam_map import state as mapstate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_CAP = mapstate.MapCapacity(n_kf=16, n_pt=2048, n_obs=6144)


def _image(seed=0, hw=(120, 160)):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (hw[0] // 8, hw[1] // 8))
    img = np.kron(base, np.ones((8, 8))) + rng.normal(0, 4, hw)
    return np.clip(img, 0, 255).astype(np.uint8)


def _frame(seed=0, n=256):
    rng = np.random.default_rng(seed)
    return FeatureFrame(
        xy=rng.integers(20, 300, (n, 2)).astype(np.float32),
        response=rng.uniform(0, 50, n).astype(np.float32),
        octave=rng.integers(0, 4, n).astype(np.int32),
        # keep clear of bin edges so small angle shifts never flip a bin
        angle=((rng.integers(0, 32, n) + rng.uniform(-0.3, 0.3, n))
               * 11.25 % 360.0).astype(np.float32),
        desc=rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32),
        valid=rng.uniform(size=n) < 0.9)


# ---------------------------------------------------------------- extractor
def test_extractor_path_is_backend_independent():
    """A non-CPU backend name changes nothing: every backend takes the
    same window-gather orientation + descriptor path."""
    p = OrbParams(n_features=200, n_levels=2)
    img = jnp.asarray(_image())
    ref = jax.device_get(extractor.extract_jit(img, p))
    with mock.patch.object(jax, "default_backend", return_value="gpu"):
        got = jax.device_get(
            jax.jit(extractor.extract, static_argnums=1)(img, p))
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)


def test_extract_is_detect_then_describe():
    p = OrbParams(n_features=200, n_levels=2)
    img = jnp.asarray(_image(1))
    atlas, blur, xy_atlas, xy, resp, octave, valid = extractor.detect(img, p)
    angle, desc = extractor.describe(atlas, blur, xy_atlas)
    ff = extractor.extract(img, p)
    np.testing.assert_array_equal(ff.desc, desc)
    np.testing.assert_array_equal(ff.angle, angle)
    np.testing.assert_array_equal(ff.xy, xy)
    assert atlas.shape == blur.shape and atlas.shape[1] == img.shape[1]


# ---------------------------------------------------------- parity helpers
def test_feature_frame_agreement_accepts_equal():
    ff = _frame()
    st = parity.feature_frame_agreement(ff, ff)
    assert st["kp_agree"] == 1.0 and st["desc_bit_agree"] == 1.0
    assert st["angle_max_err_deg"] == 0.0 and st["bin_flips"] == 0
    assert parity.feature_frame_failures(st) == []


@pytest.mark.parametrize("what", ["xy", "octave", "valid", "angle", "desc"])
def test_feature_frame_agreement_rejects_perturbed(what):
    a = _frame()
    b = a._replace()
    rng = np.random.default_rng(1)
    sel = rng.choice(a.xy.shape[0], 8, replace=False)   # ~3% of slots
    if what == "xy":
        xy = a.xy.copy()
        xy[sel, 0] += 1.0
        b = a._replace(xy=xy)
    elif what == "octave":
        o = a.octave.copy()
        o[sel] = (o[sel] + 1) % 4
        b = a._replace(octave=o)
    elif what == "valid":
        v = a.valid.copy()
        v[sel] = ~v[sel]
        b = a._replace(valid=v)
    elif what == "angle":
        ang = a.angle.copy()
        ang[sel[0]] += 0.05      # same bin, beyond 1e-2 degrees
        b = a._replace(angle=ang)
    else:
        d = a.desc.copy()
        d[sel, :] ^= np.uint32(0x0F0F0F0F)   # 16 of 256 bits on 8 slots
        b = a._replace(desc=d)
    st = parity.feature_frame_agreement(a, b)
    assert parity.feature_frame_failures(st), (what, st)


def test_rotation_angle_is_exact_near_identity():
    """Identical float32 rotations that are not exactly orthonormal read
    as 0 rad (arccos of the trace alone gave ~1e-4 rad)."""
    R = np.asarray(jax.device_get(
        jnp.asarray([[0.36, 0.48, -0.8], [-0.8, 0.6, 0.0],
                     [0.48, 0.64, 0.6]], jnp.float32) * 1.0000003))
    assert parity.rotation_angle(R, R) == 0.0
    th = 3e-5
    Rz = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                   [0, 0, 1]])
    np.testing.assert_allclose(parity.rotation_angle(R, R @ Rz), th,
                               rtol=1e-3)


def test_pose_agreement_accepts_equal_rejects_perturbed():
    rng = np.random.default_rng(0)
    R = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0]
                  for _ in range(4)])
    R *= np.sign(np.linalg.det(R))[:, None, None]
    t = rng.normal(size=(4, 3))
    assert parity.pose_failures("x", parity.pose_agreement(R, t, R, t)) == []
    t2 = t.copy()
    t2[2, 1] += 3e-4
    assert parity.pose_failures("x", parity.pose_agreement(R, t, R, t2))
    th = 5e-4
    Rx = np.array([[1, 0, 0], [0, np.cos(th), -np.sin(th)],
                   [0, np.sin(th), np.cos(th)]])
    R2 = R.copy()
    R2[1] = R[1] @ Rx
    st = parity.pose_agreement(R, t, R2, t)
    assert parity.pose_failures("x", st)
    # the masked-out pose does not count
    st = parity.pose_agreement(R, t, R2, t, mask=np.array([1, 0, 1, 1], bool))
    assert parity.pose_failures("x", st) == []


def test_preintegration_failures_bound():
    assert parity.preintegration_failures(
        dict(rot_rad=0.0, dV_rel=0.0, dP_rel=0.0)) == []
    assert len(parity.preintegration_failures(
        dict(rot_rad=2e-4, dV_rel=2e-4, dP_rel=np.nan))) == 3


# ----------------------------------------------------- phases, two devices
def test_extractor_parity_across_devices():
    d = jax.devices()
    st = parity.compare_extractor(_image(2, (240, 320)),
                                  OrbParams(n_features=300, n_levels=3),
                                  d[1], d[0])
    assert st["n_valid"] > 100
    assert parity.feature_frame_failures(st) == []


def test_preintegration_parity_across_devices():
    from orbslam3_tpu.pipeline import inertial_system
    cfg, icfg = config.euroc_mono_inertial(enable_relocalization=False,
                                           map_capacity=SMALL_CAP)
    sys_ = inertial_system.InertialSystem(cfg, icfg)
    d = jax.devices()
    st = parity.compare_preintegration(sys_, d[1], d[0])
    assert parity.preintegration_failures(st) == []


def test_partition_keeps_obs_at_exact_shard_capacity():
    """Shards filled exactly to their observation capacity lose nothing
    (overflow rows used to be clamped onto the shard's last slot)."""
    cfg = config.euroc_mono(map_capacity=SMALL_CAP)
    m = parity.synthetic_window_map(SMALL_CAP, cfg.cam_params, n_kf=6,
                                    pts_per_kf=128)
    from orbslam3_tpu.pipeline import mapping
    prob = mapping.gather_window_problem(
        m, jnp.asarray(5, jnp.int32), 8, 8, 1.2, cap_cams=8, cap_pts=512,
        cap_obs=1536)[0]
    n_obs = int(prob.obs_valid.sum())
    assert n_obs > 0
    for n in (1, 2, 4):
        assert int(dist_ba.partition_problem(prob, n).obs_valid.sum()) == \
            n_obs, n


@pytest.mark.multichip
def test_sharded_ba_parity_on_virtual_devices():
    cfg = config.euroc_mono(map_capacity=SMALL_CAP,
                            ba_caps=(8, 1024, 3072))
    failures = []
    smoke.sharded_phase(jax.devices()[:4], cfg, smoke.Log("cpu"), failures)
    assert failures == []


# ------------------------------------------------------------- guard rails
def test_ba_mesh_shards_beyond_devices_raises():
    cfg = config.euroc_mono(ba_mesh_shards=len(jax.devices()) + 1,
                            enable_relocalization=False,
                            map_capacity=SMALL_CAP)
    with pytest.raises(ValueError, match="ba_mesh_shards"):
        base_sys.System(cfg)


def _cpu_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_COMPILATION_CACHE_DIR")}
    env.update(JAX_PLATFORMS="cpu", **extra)
    return env


def _no_ok_line(stdout: str) -> bool:
    lines = stdout.strip().splitlines()
    if not lines:
        return True
    try:
        return json.loads(lines[-1]).get("ok") is not True
    except (json.JSONDecodeError, AttributeError):
        return True


def test_chip_smoke_fails_without_gpu():
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       env=_cpu_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert _no_ok_line(r.stdout)
    assert "no GPU" in r.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=_cpu_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert _no_ok_line(r.stdout)


@pytest.mark.parametrize("set_env", [True, False])
def test_compile_cache_location(tmp_path, set_env):
    code = ("import jax, orbslam3_tpu; "
            "jax.config.update('jax_persistent_cache_min_compile_time_secs',"
            " 0); jax.jit(lambda x: x * 3 + 1)(jax.numpy.ones(7))"
            ".block_until_ready(); "
            "print(jax.config.jax_compilation_cache_dir)")
    env = _cpu_env(JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cc")) \
        if set_env else _cpu_env()
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    want = str(tmp_path / "cc") if set_env else \
        os.path.join(REPO, ".jax_cache")
    assert r.stdout.split()[-1] == want
    assert os.listdir(want), "nothing was cached"


# ------------------------------------------------------------- on the card
@pytest.fixture
def gpus():
    try:
        return jax.devices("gpu")
    except RuntimeError:
        pytest.skip("no GPU visible (the tests pin the CPU); "
                    "chip_smoke.py runs this check on the card")


@pytest.mark.gpu
def test_one_card_smoke(gpus):
    failures = smoke.one_device(
        gpus[0], jax.devices("cpu")[0], config.euroc_mono(),
        *config.euroc_mono_inertial(), 120, 260, smoke.Log())
    assert failures == []


@pytest.mark.gpu
def test_four_card_sharded_ba(gpus):
    if len(gpus) < 4:
        pytest.skip("needs four GPUs")
    failures = []
    smoke.sharded_phase(gpus[:4], config.euroc_mono(
        map_capacity=mapstate.MapCapacity(n_kf=16, n_pt=4096,
                                          n_obs=12288)),
        smoke.Log(), failures)
    assert failures == []


@pytest.mark.slow
def test_one_device_smoke_at_reduced_shape():
    """The whole single-card smoke at 376x240 on two CPU devices: both
    flights through pixels to their accuracy gates, then parity."""
    small = dict(image_hw=(240, 376),
                 cam_params=(229.327, 228.648, 183.6075, 124.1875),
                 orb=OrbParams(n_features=1200, n_levels=4))
    d = jax.devices()
    failures = smoke.one_device(
        d[0], d[1], config.euroc_mono(**small),
        *config.euroc_mono_inertial(**small), 120, 260, smoke.Log())
    assert failures == []


# ------------------------------------------------- Pallas describe kernel
def _atlas_case(seed, hw, n_features, n_levels):
    p = OrbParams(n_features=n_features, n_levels=n_levels)
    img = jnp.asarray(_image(seed, hw))
    return jax.jit(extractor.detect, static_argnums=1)(img, p)[:3]


@pytest.mark.parametrize("seed,hw,n_features,n_levels", [
    (0, (120, 160), 200, 2),
    (3, (240, 320), 301, 3),     # keypoint count not a multiple of BLOCK
    (5, (96, 256), 97, 1),
])
def test_describe_kernel_matches_plain_xla(seed, hw, n_features, n_levels):
    """The Pallas kernel (interpret mode) against describe_xla: identical
    descriptors, angles equal up to the moments' summation order."""
    from orbslam3_tpu.ops import describe_kernel
    atlas, blur, xy = _atlas_case(seed, hw, n_features, n_levels)
    a_ref, d_ref = jax.device_get(
        jax.jit(extractor.describe_xla)(atlas, blur, xy))
    a_k, d_k = jax.device_get(
        describe_kernel.describe(atlas, blur, xy, interpret=True))
    assert d_k.shape == d_ref.shape and d_k.dtype == np.uint32
    assert a_k.shape == a_ref.shape
    d_ang = np.abs((a_k - a_ref + 180.0) % 360.0 - 180.0)
    assert d_ang.max() < parity.ANGLE_TOL_DEG
    np.testing.assert_array_equal(d_k, d_ref)


def test_describe_kernel_tables_match_reference_geometry():
    """Kernel tables: moment weights are the circular-mask weights padded
    to 32x32, and the pair offsets stay inside the BRIEF window."""
    from orbslam3_tpu.ops import describe_kernel, orient
    wu, wv, y0, x0, y1, x1 = describe_kernel._tables()
    wu_ref, wv_ref = orient._moment_weights()
    np.testing.assert_array_equal(wu[:31, :31], wu_ref)
    np.testing.assert_array_equal(wv[:31, :31], wv_ref)
    assert not wu[31:].any() and not wu[:, 31:].any()
    for t in (y0, x0, y1, x1):
        assert t.shape == (32, 256)
        assert t.min() >= 0 and t.max() <= 38


def test_describe_picks_plain_xla_off_cuda():
    """`describe` lowered for the CPU contains no Pallas call."""
    atlas, blur, xy = _atlas_case(0, (120, 160), 200, 2)
    hlo = jax.jit(extractor.describe).lower(atlas, blur, xy).as_text()
    assert "orb_describe" not in hlo and "triton" not in hlo.lower()
