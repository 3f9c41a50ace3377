"""Visual vocabulary for place recognition.

Behavioral parity target: DBoW2 ORB vocabulary + TF-IDF scoring
(reference Thirdparty/DBoW2/include/DBoW2/TemplatedVocabulary.h:135-171
transform; include/ORBVocabulary.h).  The reference loads a pre-trained
1M-leaf hierarchical k-means tree (ORBvoc.txt — not shipped in-repo) and
assigns each descriptor to a leaf "word" by tree descent.

Substitute: a flat codebook of `n_words` anchor descriptors;
word assignment = Hamming argmin over all anchors, computed as ONE
(N x 256) @ (256 x V) popcount matmul — flat search beats tree
descent on this hardware and removes the tree's data-dependent control
flow.  Anchors are seeded pseudo-randomly (bit patterns balanced per bit)
and can be refined online with `kmeans_refine` (k-majority over assigned
descriptors — binary k-means) as frames accumulate, converging toward a
trained codebook like DBoW2's.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import brief


@functools.lru_cache(maxsize=None)
def seed_codebook(n_words: int = 2048, seed: int = 7) -> np.ndarray:
    """(V, 8) uint32 random anchor descriptors."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, (n_words, 8), dtype=np.uint32)


def load_codebook(n_words: int = 4096,
                  prefer_trained: bool = True) -> np.ndarray:
    """Load the pretrained codebook (tools/train_vocab.py output — the
    analogue of loading ORBvoc.txt, reference src/System.cc:75-88);
    falls back to the pseudo-random seed codebook when absent."""
    if prefer_trained:
        import os
        path = os.path.join(os.path.dirname(__file__), "..", "data",
                            f"vocab_{n_words}.npy")
        if os.path.exists(path):
            cb = np.load(path)
            if cb.shape == (n_words, 8):
                return cb.astype(np.uint32)
    return seed_codebook(n_words)


def assign_words(desc: jnp.ndarray, codebook: jnp.ndarray) -> jnp.ndarray:
    """(N, 8) uint32 -> (N,) int32 word ids (Hamming argmin)."""
    d = brief.hamming_distance(desc, codebook)  # (N, V)
    return jnp.argmin(d, axis=1).astype(jnp.int32)


def assign_words_chunked(desc: jnp.ndarray, codebook: jnp.ndarray,
                         chunk: int = 2048) -> jnp.ndarray:
    """assign_words for training-scale N (the (N, V) distance matrix at
    300k descriptors x 32k words would be ~40 GB): lax.map over N-chunks
    keeps one (chunk, V) block live at a time."""
    N = desc.shape[0]
    pad = (-N) % chunk
    dp = jnp.pad(desc, ((0, pad), (0, 0)))
    blocks = dp.reshape(-1, chunk, desc.shape[1])
    out = jax.lax.map(lambda b: assign_words(b, codebook), blocks)
    return out.reshape(-1)[:N]


def bow_vector(words: jnp.ndarray, valid: jnp.ndarray,
               n_words: int) -> jnp.ndarray:
    """L1-normalized term-frequency vector (V,) (DBoW2 TF / L1-norm)."""
    tf = jnp.zeros(n_words, jnp.float32).at[words].add(
        valid.astype(jnp.float32))
    return tf / jnp.maximum(jnp.sum(tf), 1.0)


def kmeans_refine(codebook: jnp.ndarray, desc: jnp.ndarray,
                  valid: jnp.ndarray, iters: int = 2) -> jnp.ndarray:
    """Binary k-means (k-majority) refinement of the codebook over a batch
    of descriptors — the online analogue of DBoW2's offline training."""
    V = codebook.shape[0]
    bits = brief.unpack_bits(desc)          # (N, 256) {0,1}
    w = valid.astype(jnp.float32)[:, None]

    def step(cb, _):
        words = assign_words_chunked(desc, cb)
        cnt = jnp.zeros(V, jnp.float32).at[words].add(w[:, 0])
        ssum = jnp.zeros((V, 256), jnp.float32).at[words].add(bits * w)
        maj = (ssum > 0.5 * cnt[:, None]).astype(jnp.uint32)
        shifts = jnp.asarray(1 << np.arange(32, dtype=np.uint32), jnp.uint32)
        packed = jnp.sum(maj.reshape(V, 8, 32) * shifts[None, None, :],
                         axis=-1).astype(jnp.uint32)
        # keep old anchor where no descriptors were assigned
        keep = (cnt > 0)[:, None]
        return jnp.where(keep, packed, cb), None

    cb, _ = jax.lax.scan(step, codebook, None, length=iters)
    return cb
