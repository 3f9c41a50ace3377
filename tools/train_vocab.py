"""Pretrain the place-recognition codebook (binary k-means over real ORB
descriptors from synthetic textured worlds).

The reference ships a 1M-leaf DBoW2 tree trained offline on real imagery
(Thirdparty/DBoW2/include/DBoW2/TemplatedVocabulary.h:135); this is the
equivalent trainer here: it renders many random textured-plane
views, extracts REAL ORB descriptors with the production front-end, and
refines the seed codebook with k-majority iterations
(place/vocab.kmeans_refine).  Output: orbslam3_tpu/data/vocab_4096.npy,
loaded by default by LoopCloser.

Run on CPU:  python tools/train_vocab.py
On the card (32k+ words):  python tools/train_vocab.py --gpu
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402


def main(n_words: int = 4096, n_views: int = 48, seed: int = 0,
         cpu: bool = True, stage: str = "all",
         desc_file: str = "/tmp/vocab_train_descs.npz"):
    import jax
    if cpu:
        # pin the CPU even where an accelerator plug-in is installed
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from orbslam3_tpu.features.extractor import OrbParams, extract_jit
    from orbslam3_tpu.place import vocab as vocab_mod
    from orbslam3_tpu.utils import synth_render as sr

    if stage == "kmeans":
        # phase 2: k-majority refinement only (descriptors precomputed
        # by --stage extract on CPU; this phase is the matmul-heavy one)
        data = np.load(desc_file)
        desc = jnp.asarray(data["desc"])
        valid = jnp.asarray(data["valid"])
        _finish(n_words, desc, valid, vocab_mod, jnp)
        return

    rng = np.random.default_rng(seed)
    p = OrbParams(n_features=800, n_levels=4)
    K4 = jnp.asarray([458.654, 457.296, 367.215, 248.375], jnp.float32)
    hw = (480, 752)

    descs, valids = [], []
    for i in range(n_views):
        if i % 12 == 0:
            # rotate through ALL FOUR texture families so the codebook
            # generalizes (DBoW2's vocabulary is trained on diverse
            # imagery); stripe/blob added in r5 for the cross-family
            # impostor regime
            fam = (i // 12) % 4
            if fam == 0:
                tex = sr.block_texture(rng, block=int(rng.integers(5, 12)))
            elif fam == 1:
                tex = sr.voronoi_texture(rng,
                                         n_seeds=int(rng.integers(180, 500)))
            elif fam == 2:
                tex = sr.stripe_texture(rng)
            else:
                tex = sr.blob_texture(rng)
        R_cw, t_cw = sr.look_down_pose(
            float(rng.uniform(0, 8)), float(rng.uniform(0, 8)),
            float(rng.uniform(3, 7)), yaw=float(rng.uniform(0, 6.28)),
            tilt=float(rng.uniform(-0.25, 0.25)))
        img = sr.render_plane(R_cw, t_cw, np.asarray(K4), hw, tex)
        img += rng.normal(0, 2.0, img.shape).astype(np.float32)
        ff = extract_jit(jnp.asarray(np.clip(img, 0, 255)), p)
        descs.append(np.asarray(ff.desc))
        valids.append(np.asarray(ff.valid))
        if i % 20 == 0:
            print(f"view {i}: {int(valids[-1].sum())} descriptors",
                  flush=True)

    desc_np = np.concatenate(descs)
    valid_np = np.concatenate(valids)
    print(f"total descriptors: {int(valid_np.sum())}")
    if stage == "extract":
        np.savez(desc_file, desc=desc_np, valid=valid_np)
        print(f"descriptors -> {desc_file}")
        return
    _finish(n_words, jnp.asarray(desc_np), jnp.asarray(valid_np),
            vocab_mod, jnp)


def _finish(n_words, desc, valid, vocab_mod, jnp):
    cb = jnp.asarray(vocab_mod.seed_codebook(n_words))
    cb = vocab_mod.kmeans_refine(cb, desc, valid, iters=8)
    out = os.path.join(os.path.dirname(__file__), "..",
                       "orbslam3_tpu", "data", f"vocab_{n_words}.npy")
    np.save(out, np.asarray(cb))
    # report word-usage entropy as a sanity metric
    words = np.asarray(vocab_mod.assign_words_chunked(desc, cb))[
        np.asarray(valid)]
    hist = np.bincount(words, minlength=n_words).astype(np.float64)
    pmf = hist / hist.sum()
    ent = -(pmf[pmf > 0] * np.log2(pmf[pmf > 0])).sum()
    print(f"saved {out}; word entropy {ent:.2f} bits "
          f"(max {np.log2(n_words):.2f}), used {np.sum(hist > 0)} words")


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-words", type=int, default=4096)
    ap.add_argument("--n-views", type=int, default=48)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gpu", action="store_true",
                    help="train on the card (32k+ words: the k-majority "
                         "matmuls are the bulk of the work)")
    ap.add_argument("--stage", default="all",
                    choices=["all", "extract", "kmeans"])
    a = ap.parse_args()
    main(n_words=a.n_words, n_views=a.n_views, seed=a.seed,
         cpu=not a.gpu, stage=a.stage)
