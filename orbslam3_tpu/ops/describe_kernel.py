"""Pallas kernel (Triton route) for ORB orientation + descriptors.

Behavioral reference: the per-keypoint CUDA blocks of the fork
(src/cuda/Angle_gpu.cu IC_Angle_kernel, src/cuda/Orb_gpu.cu
calcOrb_kernel), each reading its keypoint-centred window.  One program
here handles `BLOCK` keypoints:

  * gathers each 31x31 window of the raw pyramid atlas (zero-padded to
    32x32) and reduces the IC moments m10, m01 in-kernel -> angle;
  * bins the angle into `brief.N_ANGLE_BINS` orientations and gathers the
    512 rotated pattern samples of the blurred window straight from
    global memory -> 256 comparison bits -> 8 packed words.

Same arithmetic as `orient.ic_angle` + `brief.compute_descriptors`, the
plain reference the tests compare it with (in interpret mode here, at
EuRoC width on the card in chip_smoke.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from . import brief, orient

BLOCK = 8            # keypoints per program
_RA = orient.HALF_PATCH_SIZE
_SA = 2 * _RA + 1    # IC window side (31), padded to 32 in the kernel
_RB = brief._PATCH_R
_SB = 2 * _RB + 1    # BRIEF window side (39)


@functools.lru_cache(maxsize=None)
def _tables():
    """Moment weights padded to 32x32, and per-bin pattern offsets from
    the BRIEF window origin, split into the first and second point of each
    pair: four (n_bins, 256) int32 tables (y0, x0, y1, x1)."""
    wu, wv = orient._moment_weights(_RA)
    pad = ((0, 32 - _SA), (0, 32 - _SA))
    off = brief._binned_offsets(brief.N_ANGLE_BINS) + _RB   # (B, 512, 2)
    return (np.pad(wu, pad), np.pad(wv, pad),
            off[:, 0::2, 1], off[:, 0::2, 0],
            off[:, 1::2, 1], off[:, 1::2, 0])


def _kernel(atlas_ref, blur_ref, ya_ref, xa_ref, yb_ref, xb_ref,
            wu_ref, wv_ref, oy0_ref, ox0_ref, oy1_ref, ox1_ref,
            angle_ref, desc_ref):
    r = jnp.arange(32, dtype=jnp.int32)
    shape = (BLOCK, 32, 32)
    rows = jnp.broadcast_to(ya_ref[...][:, None, None] + r[None, :, None],
                            shape)
    cols = jnp.broadcast_to(xa_ref[...][:, None, None] + r[None, None, :],
                            shape)
    inside = jnp.broadcast_to((r[:, None] < _SA) & (r[None, :] < _SA),
                              shape)
    img = pltriton.load(atlas_ref.at[rows, cols], mask=inside, other=0.0)
    m10 = jnp.sum(jnp.sum(img * wu_ref[...][None], axis=2), axis=1)
    m01 = jnp.sum(jnp.sum(img * wv_ref[...][None], axis=2), axis=1)
    ang = jnp.arctan2(m01, m10)
    ang = jnp.where(ang < 0, ang + 2 * jnp.pi, ang) * (180.0 / jnp.pi)
    angle_ref[...] = ang

    nb = brief.N_ANGLE_BINS
    b = jnp.floor(ang * (nb / 360.0) + 0.5).astype(jnp.int32) % nb
    b = jnp.broadcast_to(b[:, None], (BLOCK, 32))
    yb = yb_ref[...][:, None]
    xb = xb_ref[...][:, None]
    lane = jnp.arange(32, dtype=jnp.int32)
    shifts = lane.astype(jnp.uint32)[None, :]
    for w in range(8):
        pair = jnp.broadcast_to(32 * w + lane[None, :], (BLOCK, 32))
        v0 = blur_ref[yb + oy0_ref[b, pair], xb + ox0_ref[b, pair]]
        v1 = blur_ref[yb + oy1_ref[b, pair], xb + ox1_ref[b, pair]]
        bits = (v0 < v1).astype(jnp.uint32)
        desc_ref[w, :] = jnp.sum(bits << shifts, axis=1)


def describe(atlas: jnp.ndarray, atlas_blur: jnp.ndarray,
             xy: jnp.ndarray, interpret: bool = False):
    """(angle (N,) degrees, desc (N, 8) uint32) for keypoints at integer
    atlas coordinates xy (N, 2) — `features.extractor.describe`'s
    contract."""
    h, w = atlas.shape
    n = xy.shape[0]
    n_pad = -(-n // BLOCK) * BLOCK
    xi = jnp.round(xy).astype(jnp.int32)
    # window origins, clamped into the image exactly like the reference
    org = [jnp.clip(xi[:, 1] - _RA, 0, h - _SA),
           jnp.clip(xi[:, 0] - _RA, 0, w - _SA),
           jnp.clip(xi[:, 1] - _RB, 0, h - _SB),
           jnp.clip(xi[:, 0] - _RB, 0, w - _SB)]
    org = [jnp.pad(o, (0, n_pad - n)) for o in org]
    tables = [jnp.asarray(t) for t in _tables()]

    kp = pl.BlockSpec((BLOCK,), lambda i: (i,))
    whole = [pl.BlockSpec(a.shape, lambda i, nd=a.ndim: (0,) * nd)
             for a in (atlas, atlas_blur)]
    tab = [pl.BlockSpec(t.shape, lambda i: (0, 0)) for t in tables]
    angle, desc = pl.pallas_call(
        _kernel,
        out_shape=(jax.ShapeDtypeStruct((n_pad,), jnp.float32),
                   jax.ShapeDtypeStruct((8, n_pad), jnp.uint32)),
        grid=(n_pad // BLOCK,),
        in_specs=whole + [kp] * 4 + tab,
        out_specs=(kp, pl.BlockSpec((8, BLOCK), lambda i: (0, i))),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="orb_describe",
    )(atlas, atlas_blur, *org, *tables)
    return angle[:n], desc[:, :n].T
