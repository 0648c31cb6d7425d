"""The port's bag-of-words vocabulary, keyframe database and vocabulary IO
against the JAX package, on the CPU. Everything here is exact: the trained
tree level by level and bit by bit (both seed numpy's default_rng the same
way; the segment sums are integer), word ids and weights (distances are
exact f32 products, ties go to the first child as jnp.argmin's do), BoW
vectors, L1 scores and database candidates (host numpy), the .npz and
ORBvoc.txt readers, convert.vocabulary_from, and the bytes of the port's
copy of the default vocabulary.
"""

import hashlib
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amos_slam_tpu.loop import kf_database as jdb
from amos_slam_tpu.loop import vocab_io as jio
from amos_slam_tpu.loop import vocabulary as jvoc
from amos_slam_tpu_torch import convert
from amos_slam_tpu_torch.loop import kf_database as tdb
from amos_slam_tpu_torch.loop import vocab_io as tio
from amos_slam_tpu_torch.loop import vocabulary as tvoc

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_DEFAULT = ROOT / "amos_slam_tpu" / "data" / "default_vocab.npz"
PORT_DEFAULT = ROOT / "amos_slam_tpu_torch" / "data" / "default_vocab.npz"


def clusters(rng, n_clusters=20, per=50, flip=12):
    """Clustered binary descriptors: prototypes + bit flips
    (tests/test_vocabulary.py's set)."""
    protos = (rng.uniform(size=(n_clusters, 256)) < 0.5).astype(np.int8)
    descs = []
    for c in range(n_clusters):
        for _ in range(per):
            d = protos[c].copy()
            d[rng.choice(256, flip, replace=False)] ^= 1
            descs.append(d)
    return np.asarray(descs, np.int8), np.repeat(np.arange(n_clusters), per)


def same_vocabulary(j, t):
    assert (t.k, t.depth, t.n_words) == (j.k, j.depth, j.n_words)
    for lj, lt in zip(j.levels, t.levels):
        np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    for vj, vt in zip(j.node_valid, t.node_valid):
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(t.idf.numpy(), np.asarray(j.idf))


def words_of(voc_j, voc_t, desc, valid=None):
    valid = np.ones(len(desc), bool) if valid is None else valid
    wj, vj = jvoc.transform(voc_j, jnp.asarray(desc), jnp.asarray(valid))
    wt, vt = tvoc.transform(voc_t, torch.from_numpy(desc), torch.from_numpy(valid))
    return (np.asarray(wj), np.asarray(vj)), (wt.numpy(), vt.numpy())


@pytest.mark.parametrize("k,depth,iters,seed", [(4, 3, 5, 1), (8, 3, 5, 0)])
def test_train_vocabulary_equal(k, depth, iters, seed):
    descs, _ = clusters(np.random.default_rng(seed), n_clusters=30, per=40)
    j = jvoc.train_vocabulary(descs, k=k, depth=depth, iters=iters, seed=seed)
    t = tvoc.train_vocabulary(descs, k=k, depth=depth, iters=iters, seed=seed,
                              device="cpu")
    same_vocabulary(j, t)
    (wj, vj), (wt, vt) = words_of(j, t, descs)
    np.testing.assert_array_equal(wt, wj)
    np.testing.assert_array_equal(vt, vj)


@pytest.fixture(scope="module")
def default_pair():
    return jio.load_npz(str(JAX_DEFAULT)), tio.load_npz(str(PORT_DEFAULT), device="cpu")


def test_transform_default_vocabulary(default_pair):
    """Random and clustered descriptors through the 8^4 default tree, with
    invalid rows (word -1, weight 0)."""
    j, t = default_pair
    rng = np.random.default_rng(5)
    desc = np.concatenate([(rng.uniform(size=(600, 256)) < 0.5).astype(np.int8),
                           clusters(rng, 10, 40)[0]])
    valid = rng.uniform(size=len(desc)) < 0.9
    (wj, vj), (wt, vt) = words_of(j, t, desc, valid)
    np.testing.assert_array_equal(wt, wj)
    np.testing.assert_array_equal(vt, vj)
    assert (wt[~valid] == -1).all() and (vt[~valid] == 0).all()
    assert len(np.unique(wt[valid])) > 200


def test_transform_ties_take_the_first_child():
    """Equidistant children: descriptor halves set so two (or all four)
    children of a node are at the same Hamming distance; an invalid child
    is never chosen even at distance 0."""
    k, depth = 4, 2
    rng = np.random.default_rng(3)
    lvl0 = (rng.uniform(size=(4, 256)) < 0.5).astype(np.int8)
    lvl1 = (rng.uniform(size=(16, 256)) < 0.5).astype(np.int8)
    a = np.zeros(256, np.int8)
    b = np.zeros(256, np.int8)
    b[:64] = 1
    c = np.zeros(256, np.int8)
    c[64:128] = 1
    lvl0[1], lvl0[2] = b, c            # d = a: distance 64 to both
    lvl0[0] = np.ones(256, np.int8)    # far
    lvl0[3] = np.ones(256, np.int8)
    lvl1[4:8] = [b, c, b, c]           # under node 1: two pairs of ties
    v0 = np.ones(4, bool)
    v1 = np.ones(16, bool)
    v1[4] = False                      # the first tied child is invalid
    idf = rng.uniform(0.1, 2.0, 16).astype(np.float32)
    vj = jvoc.Vocabulary(k=k, depth=depth, levels=(jnp.asarray(lvl0), jnp.asarray(lvl1)),
                         node_valid=(jnp.asarray(v0), jnp.asarray(v1)), idf=jnp.asarray(idf))
    vt = convert.vocabulary_from(vj, device="cpu")
    desc = np.stack([a, a, b, c, np.ones(256, np.int8)])
    desc[1, 200] = 1
    (wj, _), (wt, _) = words_of(vj, vt, desc)
    np.testing.assert_array_equal(wt, wj)
    assert wt[0] == 1 * 4 + 1          # node 1 (first of the tie), child 5 (4 invalid)
    # a distance matrix with every child tied: word 0 in both
    flat = jvoc.Vocabulary(k=4, depth=1, levels=(jnp.asarray(np.stack([b, b, b, b])),),
                           node_valid=(jnp.ones(4, bool),), idf=jnp.ones(4))
    (wj, _), (wt, _) = words_of(flat, convert.vocabulary_from(flat, device="cpu"), desc)
    np.testing.assert_array_equal(wt, wj)
    assert (wt == 0).all()


def test_bow_and_database_equal(default_pair):
    """bow_vector, l1_score and KeyFrameDatabase add / query (with and
    without covisibility) / erase / remap give the same results."""
    j, t = default_pair
    descs, labels = clusters(np.random.default_rng(2), n_clusters=40, per=30)
    rng = np.random.default_rng(7)
    dj, dt = jdb.KeyFrameDatabase(j.n_words), tdb.KeyFrameDatabase(t.n_words)
    bows = []
    for kf in range(12):
        band = np.where((labels >= 3 * kf) & (labels < 3 * kf + 6))[0]
        ids = rng.choice(band, 100, replace=False)
        (wj, vj), (wt, vt) = words_of(j, t, descs[ids])
        np.testing.assert_array_equal(wt, wj)
        dj.add(kf, wj, vj)
        dt.add(kf, wt, vt)
        bows.append((wt, vt))
    for (w1, v1), (w2, v2) in zip(bows, bows[1:]):
        bj = jvoc.bow_vector(w1, v1, j.n_words), jvoc.bow_vector(w2, v2, j.n_words)
        bt = tvoc.bow_vector(w1, v1, t.n_words), tvoc.bow_vector(w2, v2, t.n_words)
        for x, y in zip(bj, bt):
            np.testing.assert_array_equal(x[0], y[0])
            np.testing.assert_array_equal(x[1], y[1])
        assert tvoc.l1_score(*bt[0], *bt[1]) == jvoc.l1_score(*bj[0], *bj[1])
    covis = rng.integers(0, 60, (12, 12)).astype(np.int32)
    covis = np.triu(covis, 1) + np.triu(covis, 1).T
    for q in range(12):
        w, v = bows[q]
        for kw in (dict(), dict(exclude=[q, q - 1], min_score=0.01, covis=covis,
                                max_candidates=3)):
            assert dt.query(w, v, **kw) == dj.query(w, v, **kw)
    dj.erase(4)
    dt.erase(4)
    lut = np.array([0, 1, -1, 2, -1, 3, 4, 5, 6, 7, 8, 9])
    dj.remap(lut)
    dt.remap(lut)
    assert dt.kf_bow.keys() == dj.kf_bow.keys() and dt.inverted == dj.inverted
    assert dt.query(*bows[7]) == dj.query(*bows[7])


def test_vocab_io_roundtrip_and_cross_read(tmp_path):
    descs, _ = clusters(np.random.default_rng(0), n_clusters=20, per=25)
    voc = tvoc.train_vocabulary(descs, k=4, depth=3, iters=4, seed=0, device="cpu")
    p = str(tmp_path / "voc.npz")
    tio.save_npz(p, voc)
    same_vocabulary(jio.load_npz(p), tio.load_npz(p, device="cpu"))
    same_vocabulary(jio.load_npz(p), voc)
    assert set(np.load(p).files) == {"k", "depth", "idf", "level0", "level1", "level2",
                                     "valid0", "valid1", "valid2"}


def test_load_orbvoc_txt(tmp_path):
    """tests/test_reloc_loop.py's synthetic DBoW2 text file (k=2, L=2)."""
    local = np.random.default_rng(42)

    def bytes_str(bits):
        return " ".join(str(int(b)) for b in np.packbits(bits.astype(np.uint8),
                                                        bitorder="little"))

    def perturb(x, n):
        y = x.copy()
        y[local.choice(256, n, replace=False)] ^= 1
        return y

    d = np.zeros((6, 256), np.int8)
    d[0] = (local.uniform(size=256) < 0.5).astype(np.int8)
    d[1] = 1 - d[0]
    d[2], d[3] = perturb(d[0], 8), perturb(d[0], 8)
    d[4], d[5] = perturb(d[1], 8), perturb(d[1], 8)
    lines = ["2 2 0 0", f"0 0 {bytes_str(d[0])} 0", f"0 0 {bytes_str(d[1])} 0",
             f"1 1 {bytes_str(d[2])} 0.5", f"1 1 {bytes_str(d[3])} 0.25",
             f"2 1 {bytes_str(d[4])} 0.7", f"2 1 {bytes_str(d[5])} 0.1"]
    p = str(tmp_path / "voc.txt")
    with open(p, "w") as f:
        f.write("\n".join(lines) + "\n")
    j, t = jio.load_orbvoc_txt(p), tio.load_orbvoc_txt(p, device="cpu")
    same_vocabulary(j, t)
    (wj, vj), (wt, vt) = words_of(j, t, d[2:])
    np.testing.assert_array_equal(wt, wj)
    np.testing.assert_array_equal(vt, vj)
    assert list(wt) == [0, 1, 2, 3] and vt[0] == np.float32(0.5)


def test_vocabulary_from(default_pair):
    j, t = default_pair
    same_vocabulary(j, convert.vocabulary_from(j, device="cpu"))
    same_vocabulary(j, t)


def test_default_vocabulary_is_a_byte_copy():
    """The port reads its own copy; its bytes are the JAX package's."""
    a, b = JAX_DEFAULT.read_bytes(), PORT_DEFAULT.read_bytes()
    assert len(b) == 180575
    assert hashlib.sha256(a).hexdigest() == hashlib.sha256(b).hexdigest()


@pytest.mark.parametrize("entry", ["train_vocabulary", "load_npz", "load_orbvoc_txt",
                                   "vocabulary_from"])
def test_entry_points_default_to_cuda(entry, tmp_path):
    """Without ``device`` each vocabulary entry point goes to the CUDA card,
    and raises where there is none."""
    descs, _ = clusters(np.random.default_rng(0), n_clusters=4, per=10)
    txt = tmp_path / "voc.txt"
    txt.write_text("2 1 0 0\n" + "".join(f"0 1 {' '.join(['0'] * 32)} 0.5\n" for _ in range(2)))
    call = {
        "train_vocabulary": lambda: tvoc.train_vocabulary(descs, k=2, depth=2, iters=1),
        "load_npz": lambda: tio.load_npz(str(PORT_DEFAULT)),
        "load_orbvoc_txt": lambda: tio.load_orbvoc_txt(str(txt)),
        "vocabulary_from": lambda: convert.vocabulary_from(jio.load_npz(str(PORT_DEFAULT))),
    }[entry]
    if torch.cuda.is_available():
        assert call().idf.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
