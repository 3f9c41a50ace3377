"""Place-recognition recall/precision vs map size and vocabulary size.

VERDICT r3 missing #5: at 256-KF capacity with aliased textures, the
TF-IDF discrimination of the vocabulary is the binding constraint on
loop precision — this tool measures it.

Protocol: P aliased "places" (distinct look-down positions drawing from
a SMALL pool of texture instances across two families, so different
places share local appearance), one nominal render per place registered
in the keyframe database, one stressed re-render per place (exposure /
gamma / noise / small pose offset) as the query.  For map sizes
M in {32, 64, 128, 256} and each vocabulary, reports recall@1 and
recall@3 (fraction of queries whose true place ranks first / within the
top 3 DB scores) and the mean true/best-impostor score margin.

Run:  python tools/vocab_recall_curve.py [--cpu]
(default device unless --cpu.)
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

P_PLACES = int(os.environ.get("RECALL_PLACES", 256))
MAP_SIZES = tuple(int(x) for x in os.environ.get(
    "RECALL_SIZES", "32,64,128,256").split(","))


def main(cpu: bool = False, vocabs=None):
    if vocabs is None:
        vocabs = tuple(int(v) for v in os.environ.get(
            "RECALL_VOCABS", "4096,32768").split(","))
    import jax
    if cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from orbslam3_tpu.features.extractor import OrbParams, extract_jit
    from orbslam3_tpu.place import keyframe_db as kdb
    from orbslam3_tpu.place import vocab as vocab_mod
    from orbslam3_tpu.utils import synth_render as sr

    print("devices:", jax.devices(), flush=True)
    rng = np.random.default_rng(11)
    p = OrbParams(n_features=800, n_levels=4)
    K4 = np.asarray([458.654, 457.296, 367.215, 248.375], np.float32)
    hw = (480, 752)

    # texture pool: POOL/4 instances x 4 families (block / voronoi /
    # stripe / blob — cross-family impostors), reused by all places.
    # Default pool keeps the r4 aliasing DENSITY (32 places per texture
    # instance) constant as the DB scales, so the curve measures DB-size
    # confusability, not a harder aliasing ratio.
    n_pool = int(os.environ.get("RECALL_POOL", max(P_PLACES // 32, 8)))
    pool = []
    for k in range(max(n_pool // 4, 1)):
        pool.append(sr.block_texture(rng, block=int(rng.integers(6, 11))))
        pool.append(sr.voronoi_texture(rng,
                                       n_seeds=int(rng.integers(200, 420))))
        pool.append(sr.stripe_texture(rng))
        pool.append(sr.blob_texture(rng))

    t0 = time.time()
    db_desc, db_valid, q_desc, q_valid = [], [], [], []
    for k in range(P_PLACES):
        tex = pool[k % len(pool)]
        x, y = float(rng.uniform(0, 14)), float(rng.uniform(0, 14))
        z = float(rng.uniform(4, 6))
        yaw = float(rng.uniform(0, 6.28))
        img = sr.render_plane(*sr.look_down_pose(x, y, z, yaw=yaw),
                              K4, hw, tex)
        img = np.clip(img + rng.normal(0, 1.5, img.shape), 0, 255)
        ff = extract_jit(jnp.asarray(img.astype(np.uint8)), p)
        db_desc.append(np.asarray(ff.desc))
        db_valid.append(np.asarray(ff.valid))
        # stressed revisit: small pose offset + photometric shift
        img_q = sr.render_plane(
            *sr.look_down_pose(x + float(rng.uniform(-0.2, 0.2)),
                               y + float(rng.uniform(-0.2, 0.2)),
                               z * float(rng.uniform(0.97, 1.03)),
                               yaw=yaw + float(rng.uniform(-0.1, 0.1))),
            K4, hw, tex)
        img_q = sr.photometric_stress(
            img_q, exposure=float(rng.uniform(0.7, 1.3)),
            gamma=float(rng.uniform(0.9, 1.12)), vignette=0.3,
            noise=4.0, rng=rng)
        ffq = extract_jit(jnp.asarray(
            np.clip(img_q, 0, 255).astype(np.uint8)), p)
        q_desc.append(np.asarray(ffq.desc))
        q_valid.append(np.asarray(ffq.valid))
        if k % 64 == 0:
            print(f"place {k}/{P_PLACES} ({time.time() - t0:.0f}s)",
                  flush=True)

    print("| vocab | map size | recall@1 | recall@3 | margin |")
    print("|---|---|---|---|---|")
    rows = []
    for V in vocabs:
        cb = jnp.asarray(vocab_mod.load_codebook(V, prefer_trained=True))

        @jax.jit
        def bow(d, v, cb=cb, V=V):
            w = vocab_mod.assign_words(d, cb)
            return vocab_mod.bow_vector(w, v, V)

        bows_db = [bow(jnp.asarray(d), jnp.asarray(v))
                   for d, v in zip(db_desc, db_valid)]
        bows_q = [bow(jnp.asarray(d), jnp.asarray(v))
                  for d, v in zip(q_desc, q_valid)]
        for M in MAP_SIZES:
            db = kdb.KeyframeDB.create(M, V)
            for k in range(M):
                db = kdb.add(db, k, bows_db[k])
            r1 = r3 = 0
            margins = []
            for k in range(M):
                scores, _ = kdb.query(db, bows_q[k])
                s = np.asarray(scores)
                order = np.argsort(-s)
                rank = int(np.where(order == k)[0][0])
                r1 += rank == 0
                r3 += rank < 3
                imp = np.delete(s, k)
                margins.append(float(s[k] - imp.max()))
            rows.append((V, M, r1 / M, r3 / M, np.mean(margins)))
            print(f"| {V} | {M} | {r1 / M:.3f} | {r3 / M:.3f} | "
                  f"{np.mean(margins):+.4f} |", flush=True)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args()
    main(cpu=a.cpu)
