"""On-manifold IMU preintegration (Forster et al.).

Numerics transcribed from the reference's update equations
(/root/reference/src/ImuTypes.cc:179-240 IntegrateNewMeasurement,
:86 IntegratedRotation, :285+ bias-corrected getters), re-expressed as a
masked `lax.scan` over a fixed-capacity measurement buffer so the whole
frame's preintegration compiles to one fused XLA loop (no per-sample host
dispatch like the reference's per-measurement C++ calls).

State layout (f32):
  dR (3,3)   rotation delta
  dV, dP (3,) velocity / position deltas
  JRg, JVg, JVa, JPg, JPa (3,3)  bias Jacobians
  C (15,15)  covariance: [0:3 rot, 3:6 vel, 6:9 pos, 9:12 gyro walk, 12:15 acc walk]
  dT ()      total time
  avg_a, avg_w (3,)  averaged specific force / angular rate
  b (6,)     linearization bias [gyro(3), acc(3)]

Calib covariances: Nga = diag([sg^2 x3, sa^2 x3]), NgaWalk likewise with the
walk sigmas; the reference scales continuous-time densities by sqrt(freq)
(/root/reference/src/Tracking.cc:122-123).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import lie

_HI = jax.lax.Precision.HIGHEST


class ImuCalib(NamedTuple):
    """Discrete-time IMU noise (already scaled by sqrt(freq))."""
    sigma_g: jnp.ndarray   # () gyro noise
    sigma_a: jnp.ndarray   # () accel noise
    sigma_gw: jnp.ndarray  # () gyro walk
    sigma_aw: jnp.ndarray  # () accel walk
    Tbc_R: jnp.ndarray     # (3,3) camera->body rotation
    Tbc_t: jnp.ndarray     # (3,) camera->body translation

    @staticmethod
    def create(noise_gyro, noise_acc, walk_gyro, walk_acc, freq,
               Tbc_R=None, Tbc_t=None):
        sf = jnp.sqrt(jnp.asarray(freq, jnp.float32))
        return ImuCalib(
            sigma_g=jnp.asarray(noise_gyro, jnp.float32) * sf,
            sigma_a=jnp.asarray(noise_acc, jnp.float32) * sf,
            sigma_gw=jnp.asarray(walk_gyro, jnp.float32) / sf,
            sigma_aw=jnp.asarray(walk_acc, jnp.float32) / sf,
            Tbc_R=jnp.eye(3) if Tbc_R is None else jnp.asarray(Tbc_R, jnp.float32),
            Tbc_t=jnp.zeros(3) if Tbc_t is None else jnp.asarray(Tbc_t, jnp.float32),
        )


class Preintegrated(NamedTuple):
    dR: jnp.ndarray
    dV: jnp.ndarray
    dP: jnp.ndarray
    JRg: jnp.ndarray
    JVg: jnp.ndarray
    JVa: jnp.ndarray
    JPg: jnp.ndarray
    JPa: jnp.ndarray
    C: jnp.ndarray
    dT: jnp.ndarray
    avg_a: jnp.ndarray
    avg_w: jnp.ndarray
    b: jnp.ndarray  # linearization bias [gyro(3), acc(3)]


GRAVITY = jnp.array([0.0, 0.0, -9.81], dtype=jnp.float32)  # world gravity
GRAVITY_MAGNITUDE = 9.81


def init_preintegrated(bias: jnp.ndarray | None = None) -> Preintegrated:
    if bias is None:
        bias = jnp.zeros(6, jnp.float32)
    z3 = jnp.zeros((3, 3), jnp.float32)
    return Preintegrated(
        dR=jnp.eye(3, dtype=jnp.float32),
        dV=jnp.zeros(3, jnp.float32),
        dP=jnp.zeros(3, jnp.float32),
        JRg=z3, JVg=z3, JVa=z3, JPg=z3, JPa=z3,
        C=jnp.zeros((15, 15), jnp.float32),
        dT=jnp.zeros((), jnp.float32),
        avg_a=jnp.zeros(3, jnp.float32),
        avg_w=jnp.zeros(3, jnp.float32),
        b=bias,
    )


def _integrated_rotation(wdt: jnp.ndarray):
    """deltaR = Exp(w dt) and its right Jacobian (reference
    IntegratedRotation ctor — first-order branch below eps handled by the
    Taylor guards inside lie)."""
    return lie.exp_so3(wdt), lie.right_jacobian_so3(wdt)


def integrate_step(st: Preintegrated, acc: jnp.ndarray, gyro: jnp.ndarray,
                   dt: jnp.ndarray, calib: ImuCalib,
                   valid: jnp.ndarray | None = None) -> Preintegrated:
    """One measurement update; `valid=False` makes it an exact no-op."""
    if valid is None:
        valid = jnp.asarray(True)
    dt = jnp.where(valid, dt, 0.0)

    bg, ba = st.b[:3], st.b[3:]
    a = acc - ba
    w = gyro - bg

    denom = st.dT + dt
    safe = jnp.where(denom > 0, denom, 1.0)
    avg_a = jnp.where(denom > 0,
                      (st.dT * st.avg_a + st.dR @ a * dt) / safe, st.avg_a)
    avg_w = jnp.where(denom > 0, (st.dT * st.avg_w + w * dt) / safe, st.avg_w)

    # position/velocity use the *pre-update* rotation
    dP = st.dP + st.dV * dt + 0.5 * st.dR @ a * dt * dt
    dV = st.dV + st.dR @ a * dt

    Wacc = lie.hat(a)
    dRdt = st.dR * dt

    # bias Jacobians (pre-update rotation)
    JPa = st.JPa + st.JVa * dt - 0.5 * dRdt * dt
    JPg = st.JPg + st.JVg * dt - 0.5 * dt * jnp.matmul(
        jnp.matmul(dRdt, Wacc, precision=_HI), st.JRg, precision=_HI)
    JVa = st.JVa - dRdt
    JVg = st.JVg - jnp.matmul(jnp.matmul(dRdt, Wacc, precision=_HI),
                              st.JRg, precision=_HI)

    # rotation update
    dRi, rightJ = _integrated_rotation(w * dt)
    dR = lie.normalize_rotation(jnp.matmul(st.dR, dRi, precision=_HI))

    # covariance propagation: x = [rot, vel, pos]
    A = jnp.eye(9, dtype=jnp.float32)
    A = A.at[0:3, 0:3].set(dRi.T)
    A = A.at[3:6, 0:3].set(-jnp.matmul(dRdt, Wacc, precision=_HI))
    A = A.at[6:9, 0:3].set(-0.5 * dt * jnp.matmul(dRdt, Wacc, precision=_HI))
    A = A.at[6:9, 3:6].set(jnp.eye(3) * dt)
    B = jnp.zeros((9, 6), jnp.float32)
    B = B.at[0:3, 0:3].set(rightJ * dt)
    B = B.at[3:6, 3:6].set(dRdt)
    B = B.at[6:9, 3:6].set(0.5 * dRdt * dt)

    Nga = jnp.diag(jnp.concatenate([
        jnp.full(3, calib.sigma_g ** 2), jnp.full(3, calib.sigma_a ** 2)]))
    C99 = (jnp.matmul(jnp.matmul(A, st.C[:9, :9], precision=_HI), A.T,
                      precision=_HI)
           + jnp.matmul(jnp.matmul(B, Nga, precision=_HI), B.T, precision=_HI))
    C = st.C.at[:9, :9].set(C99)
    walk = jnp.concatenate([
        jnp.full(3, calib.sigma_gw ** 2), jnp.full(3, calib.sigma_aw ** 2)])
    C = C.at[9:15, 9:15].add(jnp.where(valid, 1.0, 0.0) * jnp.diag(walk))

    JRg = jnp.matmul(dRi.T, st.JRg, precision=_HI) - rightJ * dt

    new = Preintegrated(dR=dR, dV=dV, dP=dP, JRg=JRg, JVg=JVg, JVa=JVa,
                        JPg=JPg, JPa=JPa, C=C, dT=st.dT + dt,
                        avg_a=avg_a, avg_w=avg_w, b=st.b)
    # exact no-op when invalid (dt=0 already nearly does it; force identity)
    return jax.tree.map(lambda n, o: jnp.where(valid, n, o), new, st)


def preintegrate(acc: jnp.ndarray, gyro: jnp.ndarray, dt: jnp.ndarray,
                 mask: jnp.ndarray, calib: ImuCalib,
                 bias: jnp.ndarray | None = None) -> Preintegrated:
    """Integrate a fixed-capacity batch of measurements.

    acc, gyro: (N, 3); dt, mask: (N,).  Invalid entries are no-ops, so the
    caller pads to capacity.  Equivalent to the reference's sequential
    IntegrateNewMeasurement loop; runs as one `lax.scan` on device.
    """
    st0 = init_preintegrated(bias)

    def body(st, x):
        a, w, d, m = x
        return integrate_step(st, a, w, d, calib, m), None

    # unroll=8: the integration is inherently sequential, so the scan's
    # cost at 512-1024 rows is dominated by per-iteration loop
    # turnaround on device; unrolling packs 8 dependent updates per
    # loop trip
    st, _ = jax.lax.scan(body, st0, (acc, gyro, dt, mask), unroll=8)
    return st


def reintegrate(st_meas, calib: ImuCalib, new_bias: jnp.ndarray,
                acc, gyro, dt, mask) -> Preintegrated:
    """Re-run integration at a new linearization bias (reference
    Preintegrated::Reintegrate)."""
    return preintegrate(acc, gyro, dt, mask, calib, new_bias)


# --- bias-corrected getters (reference ImuTypes.cc:285-330) ---------------

def delta_rotation(st: Preintegrated, bias: jnp.ndarray) -> jnp.ndarray:
    dbg = bias[:3] - st.b[:3]
    return lie.normalize_rotation(
        jnp.matmul(st.dR, lie.exp_so3(st.JRg @ dbg), precision=_HI))


def delta_velocity(st: Preintegrated, bias: jnp.ndarray) -> jnp.ndarray:
    dbg, dba = bias[:3] - st.b[:3], bias[3:] - st.b[3:]
    return st.dV + st.JVg @ dbg + st.JVa @ dba


def delta_position(st: Preintegrated, bias: jnp.ndarray) -> jnp.ndarray:
    dbg, dba = bias[:3] - st.b[:3], bias[3:] - st.b[3:]
    return st.dP + st.JPg @ dbg + st.JPa @ dba


def predict_state(Rwb1, twb1, v1, bias, st: Preintegrated, g=GRAVITY):
    """IMU state prediction from KF1 to KF2 (reference
    Tracking::PredictStateIMU, src/Tracking.cc:293-350):
      R2 = R1 dR(b),  v2 = v1 + g t + R1 dV(b),  p2 = p1 + v1 t + .5 g t^2 + R1 dP(b)
    """
    t = st.dT
    dR = delta_rotation(st, bias)
    dV = delta_velocity(st, bias)
    dP = delta_position(st, bias)
    R2 = lie.normalize_rotation(jnp.matmul(Rwb1, dR, precision=_HI))
    v2 = v1 + g * t + Rwb1 @ dV
    t2 = twb1 + v1 * t + 0.5 * g * t * t + Rwb1 @ dP
    return R2, t2, v2
