"""Loop closing components: vocabulary, KF database, Sim3 verify + pose graph."""
import jax
import jax.numpy as jnp
import numpy as np

from geoflowslam.math import lie
from geoflowslam.retrieval import vocab as V
from geoflowslam.retrieval import kf_database as DB
from geoflowslam.solvers import pose_graph as PG
from geoflowslam.state import map_state as M


def random_desc(key, n):
    return jax.random.randint(key, (n, 8), 0, 2**31 - 1, dtype=jnp.int32).astype(jnp.uint32)


def perturb_desc(key, desc, n_bits):
    out = np.asarray(desc).copy()
    rng = np.random.RandomState(int(jax.random.randint(key, (), 0, 1 << 30)))
    for i in range(len(out)):
        for b in rng.choice(256, n_bits, replace=False):
            out[i, b // 32] ^= np.uint32(1 << (b % 32))
    return jnp.asarray(out)


class TestVocabulary:
    def test_build_and_descend(self):
        key = jax.random.PRNGKey(0)
        train = random_desc(key, 2000)
        voc = V.build_vocabulary(np.asarray(train), k=8, levels=2, iters=3)
        assert voc.n_words == 64
        words = V.descend(voc, train[:100], jnp.ones(100, bool))
        assert int(words.min()) >= 0 and int(words.max()) < 64
        # same descriptor -> same word; invalid -> -1
        w2 = V.descend(voc, train[:100], jnp.zeros(100, bool))
        assert int(w2.max()) == -1

    def test_similarity_scoring(self):
        key = jax.random.PRNGKey(1)
        train = random_desc(key, 3000)
        voc = V.build_vocabulary(np.asarray(train), k=8, levels=2, iters=3)
        img_a = train[:300]
        img_a_noisy = perturb_desc(jax.random.PRNGKey(2), img_a, 8)
        img_b = random_desc(jax.random.PRNGKey(3), 300)
        va = V.bow_vector(voc, V.descend(voc, img_a, jnp.ones(300, bool)))
        van = V.bow_vector(voc, V.descend(voc, img_a_noisy, jnp.ones(300, bool)))
        vb = V.bow_vector(voc, V.descend(voc, img_b, jnp.ones(300, bool)))
        s_same = float(V.l1_score(va, van))
        s_diff = float(V.l1_score(va, vb))
        assert s_same > s_diff + 0.1, (s_same, s_diff)


class TestKFDatabase:
    def test_retrieval_excludes_covisible(self):
        key = jax.random.PRNGKey(4)
        ms = M.create(8, 64, 512)
        train = random_desc(key, 1000)
        voc = V.build_vocabulary(np.asarray(train), k=8, levels=2, iters=3)
        db = DB.KFDatabase.create(8, voc.n_words)
        # 3 KFs: 0 and 2 share appearance; 1 different. Make them temporally
        # well separated and non-covisible.
        d0 = train[:64]
        d1 = random_desc(jax.random.PRNGKey(5), 64)
        d2 = perturb_desc(jax.random.PRNGKey(6), d0, 6)
        for slot, (d, tm) in enumerate([(d0, 0.0), (d1, 50.0), (d2, 100.0)]):
            ms = M.insert_keyframe(
                ms, jnp.int32(slot), jnp.eye(3), jnp.zeros(3), jnp.zeros(3),
                jnp.zeros(6), jnp.float32(tm), jnp.zeros((64, 2)),
                jnp.zeros(64, jnp.int32), jnp.zeros(64), d,
                jnp.full((64,), -1.0), jnp.ones(64, bool),
                jnp.full((64,), M.NO_MP, jnp.int32), jnp.int32(-1))
            db = DB.add_keyframe(db, voc, jnp.int32(slot), d, jnp.ones(64, bool))
        qvec = db.bow[2]
        idx, score, ok = DB.detect_candidates(db, ms, qvec, jnp.int32(2), n_best=2)
        assert bool(ok[0])
        assert int(idx[0]) == 0   # the matching-appearance KF wins


class TestPoseGraph:
    def test_loop_correction_reduces_drift(self):
        # chain of 6 poses along x with accumulated drift; loop edge says
        # pose5 should coincide with pose0.
        k = 6
        base_rot = jnp.broadcast_to(jnp.eye(3), (k, 3, 3)).copy()
        drift = 0.12
        xs = [0.0, 1.0, 2.0, 2.0 + drift, 1.0 + 2 * drift, 0.0 + 3 * drift]
        base_t = jnp.asarray([[-x, 0, 0] for x in xs], jnp.float32)  # Tcw: t = -x
        base_s = jnp.ones((k,))

        # odometry edges measure the TRUE relative motion (1m steps around a
        # loop); the accumulated estimate drifted.
        true_xs = [0.0, 1.0, 2.0, 2.0, 1.0, 0.0]
        ei, ej, rrel, trel = [], [], [], []
        for n in range(k - 1):
            ei.append(n); ej.append(n + 1)
            # S_ij = S_i S_j^-1: for identity rotations t_rel = t_i - t_j
            trel.append([-(true_xs[n] - true_xs[n + 1]), 0, 0])
            rrel.append(np.eye(3))
        # loop edge 0 <-> 5: identical pose
        ei.append(0); ej.append(5)
        trel.append([0.0, 0, 0]); rrel.append(np.eye(3))

        e = len(ei)
        edges = PG.PoseGraphEdges(
            i=jnp.asarray(ei, jnp.int32), j=jnp.asarray(ej, jnp.int32),
            s=jnp.ones(e), rot=jnp.asarray(np.stack(rrel), jnp.float32),
            t=jnp.asarray(trel, jnp.float32),
            weight=jnp.asarray([1.0] * (e - 1) + [5.0]),
            valid=jnp.ones(e, bool))
        fixed = jnp.zeros(k, bool).at[0].set(True)
        s2, r2, t2 = PG.optimize_pose_graph(
            base_s, base_rot, base_t, jnp.ones(k, bool), fixed, edges,
            fix_scale=True, iters=20)
        # after optimization pose5 ~ pose0 and drift is spread out
        np.testing.assert_allclose(np.asarray(t2[5]), np.asarray(t2[0]), atol=0.02)
        err_before = abs(xs[5] - true_xs[5])
        err_after = abs(float(-t2[5][0]) - true_xs[5])
        assert err_after < 0.3 * err_before

    def test_sim3_log_roundtrip(self):
        xi = jnp.array([0.2, -0.1, 0.3, 0.1, 0.2, -0.15, 0.1])
        s, r, t = lie.sim3_exp(xi)
        xi2 = PG._sim3_log(s, r, t)
        np.testing.assert_allclose(np.asarray(xi2), np.asarray(xi), atol=1e-4)


def test_dbow2_text_loader(tmp_path):
    """Round-trip a tiny synthetic DBoW2-format vocabulary (k=2, L=2)."""
    # hierarchical structure: branch 1 = low-bit-weight descriptors, branch 2
    # = high-weight, so greedy descent is unambiguous
    lines = ["2 2 0 0"]
    descs = {
        1: np.zeros(32, np.uint8),
        2: np.full(32, 255, np.uint8),
        3: np.r_[np.array([1], np.uint8), np.zeros(31, np.uint8)],
        4: np.r_[np.array([0, 3], np.uint8), np.zeros(30, np.uint8)],
        5: np.r_[np.array([254], np.uint8), np.full(31, 255, np.uint8)],
        6: np.r_[np.array([255, 252], np.uint8), np.full(30, 255, np.uint8)],
    }
    for nid, parent, leaf in [(1, 0, 0), (2, 0, 0), (3, 1, 1), (4, 1, 1),
                              (5, 2, 1), (6, 2, 1)]:
        d = descs[nid]
        lines.append(f"{parent} {leaf} " + " ".join(map(str, d)) + " 0.5")
    p = str(tmp_path / "voc.txt")
    open(p, "w").write("\n".join(lines) + "\n")

    voc = V.load_dbow2_text(p)
    assert voc.k == 2 and voc.levels == 2 and voc.n_words == 4
    # descending each leaf's own descriptor must land on that leaf's word
    for nid, word in [(3, 0), (4, 1), (5, 2), (6, 3)]:
        leaf_desc = np.frombuffer(descs[nid].tobytes(), np.uint32)
        w = V.descend(voc, jnp.asarray(leaf_desc)[None], jnp.ones(1, bool))
        assert int(w[0]) == word, (nid, int(w[0]))
