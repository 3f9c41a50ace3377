"""Keyframe database: inverted-file place recognition over BoW vectors.

Parity target: reference KeyFrameDatabase (src/KeyFrameDatabase.cc) —
add/erase/clear (:38-97) and the candidate detectors: DetectCandidates
(min-score gated, :226), DetectBestCandidates (:466),
DetectNBestCandidates (covisibility-group accumulated scores, :602),
DetectRelocalizationCandidates (:731).

Design: the inverted file (word -> keyframes) exists to sparsify CPU
scoring; here the database is a dense (K, V) TF matrix and every query
is one matvec — mathematically the same L1/TF-IDF family score over ALL
keyframes at once, so the "inverted index" is the matmul itself.  IDF
weights are recomputed from document frequencies on the fly.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class KeyframeDB(NamedTuple):
    tf: jnp.ndarray        # (K, V) L1-normalized term frequencies
    has_word: jnp.ndarray  # (K, V) bool — word presence per KF
    active: jnp.ndarray    # (K,) bool — KF registered

    @staticmethod
    def create(n_kf: int, n_words: int) -> "KeyframeDB":
        return KeyframeDB(
            tf=jnp.zeros((n_kf, n_words), jnp.float32),
            has_word=jnp.zeros((n_kf, n_words), bool),
            active=jnp.zeros(n_kf, bool))


def add(db: KeyframeDB, kf_idx, bow: jnp.ndarray) -> KeyframeDB:
    """Register a keyframe's BoW vector (reference KeyFrameDatabase::add)."""
    return KeyframeDB(
        tf=db.tf.at[kf_idx].set(bow),
        has_word=db.has_word.at[kf_idx].set(bow > 0),
        active=db.active.at[kf_idx].set(True))


def erase(db: KeyframeDB, kf_idx) -> KeyframeDB:
    return KeyframeDB(
        tf=db.tf.at[kf_idx].set(0.0),
        has_word=db.has_word.at[kf_idx].set(False),
        active=db.active.at[kf_idx].set(False))


def clear(db: KeyframeDB) -> KeyframeDB:
    return KeyframeDB.create(db.tf.shape[0], db.tf.shape[1])


def idf_weights(db: KeyframeDB) -> jnp.ndarray:
    """(V,) inverse document frequency: log(N / n_docs_with_word)."""
    n_docs = jnp.maximum(jnp.sum(db.active.astype(jnp.float32)), 1.0)
    dfreq = jnp.sum(db.has_word & db.active[:, None], axis=0).astype(
        jnp.float32)
    return jnp.log(n_docs / jnp.maximum(dfreq, 1.0) + 1.0)


def query(db: KeyframeDB, bow: jnp.ndarray,
          exclude: jnp.ndarray | None = None,
          min_common_words: int = 5):
    """Score all keyframes against a query BoW vector.

    Returns (scores (K,), n_common_words (K,)).  `exclude`: (K,) bool of
    keyframes to mask (the reference excludes the query's covisibility
    group — callers pass that mask).  Scoring: TF-IDF weighted dot product
    (same monotone family as DBoW2's L1 score; candidates additionally
    require >= min_common_words shared words like the reference's
    minCommonWords = 0.8 * maxCommonWords gate).
    """
    idf = idf_weights(db)
    q = bow * idf
    scores = jnp.einsum("kv,v->k", db.tf * idf[None, :], q)
    common = jnp.sum(db.has_word & (bow > 0)[None, :], axis=1)
    ok = db.active & (common >= min_common_words)
    if exclude is not None:
        ok &= ~exclude
    return jnp.where(ok, scores, -1.0), common


def detect_candidates(db: KeyframeDB, bow: jnp.ndarray,
                      exclude: jnp.ndarray, covis: jnp.ndarray,
                      n_best: int = 3):
    """DetectNBestCandidates parity: score each KF, accumulate scores over
    its covisibility group (covis: (K, K) bool adjacency), return the
    top-n group-leading keyframes.

    Returns (cand_idx (n_best,), cand_score (n_best,)) with -1 padding.
    """
    scores, common = query(db, bow, exclude)
    # relative common-word gate (reference: minCommonWords = 0.8 * max)
    max_common = jnp.max(jnp.where(scores >= 0, common, 0))
    ok = scores >= 0
    ok &= common >= (0.8 * max_common).astype(common.dtype)
    s = jnp.where(ok, scores, 0.0)
    # accumulate over covisibility groups; each KF's group score
    grp = s + jnp.einsum("kj,j->k", covis.astype(jnp.float32), s)
    grp = jnp.where(ok, grp, -1.0)
    top_s, top_i = jax.lax.top_k(grp, n_best)
    return jnp.where(top_s > 0, top_i, -1), top_s
