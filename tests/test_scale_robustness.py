"""Round-2 robustness: slot recycling hygiene, capacity guards, epoch
timestamps, loop-closing temporal consistency, async GBA."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from geoflowslam.state import map_state as M


def _populated_ms(k=4, n=16, m=64, all_mp_valid=False):
    ms = M.create(k, n, m)
    key = jax.random.PRNGKey(0)
    for s in range(k):
        obs = jnp.arange(s * n, (s + 1) * n, dtype=jnp.int32) % m
        ms = M.insert_keyframe(
            ms, jnp.int32(s), jnp.eye(3), jnp.zeros(3), jnp.zeros(3),
            jnp.zeros(6), jnp.float32(s * 0.5),
            jax.random.uniform(key, (n, 2)) * 100,
            jnp.zeros(n, jnp.int32), jnp.zeros(n),
            jax.random.randint(key, (n, 8), 0, 2**31 - 1,
                               jnp.int32).astype(jnp.uint32),
            jnp.full((n,), 2.0), jnp.ones(n, bool), obs, jnp.int32(s - 1))
    if all_mp_valid:
        ms = ms._replace(mp_valid=jnp.ones(m, bool),
                         mp_map_id=jnp.zeros(m, jnp.int32),
                         mp_found=jnp.arange(m, dtype=jnp.float32),
                         mp_visible=jnp.full((m,), float(m)))
    return ms


class TestSlotRecycling:
    def test_invalid_slots_consumed_before_live(self):
        """With spare invalid slots, no live point may be recycled even when
        the use-mask is scattered (keypoint-aligned slot lists)."""
        ms = _populated_ms()
        ms = ms._replace(mp_valid=ms.mp_valid.at[:40].set(True)
                         .at[40:].set(False))
        use = jnp.zeros(16, bool).at[jnp.array([3, 7, 11])].set(True)
        ms2, slots = M.free_mp_slots(ms, 16, use_mask=use)
        used = np.asarray(slots)[np.asarray(use)]
        # the three used slots must all be from the invalid range
        assert (used >= 40).all(), used
        # no live point lost
        assert int(jnp.sum(ms2.mp_valid)) == 40

    def test_recycled_live_slot_detaches_observations(self):
        """Under true capacity pressure, a recycled live slot must not leave
        stale kf_obs_mp references behind (they would attach to the new
        point and corrupt covisibility/BA)."""
        ms = _populated_ms(all_mp_valid=True)
        use = jnp.ones(16, bool)
        ms2, slots = M.free_mp_slots(ms, 16, use_mask=use)
        evicted = np.asarray(slots)
        obs = np.asarray(ms2.kf_obs_mp)
        for s in evicted:
            assert not (obs == s).any(), s
        assert not np.asarray(ms2.mp_valid)[evicted].any()

    def test_capacity_left_counts(self):
        ms = _populated_ms(k=4)
        assert int(M.kf_capacity_left(ms)) == 0
        # dormant-map KFs are evictable
        ms2 = ms._replace(kf_map_id=ms.kf_map_id.at[0].set(99))
        assert int(M.kf_capacity_left(ms2)) == 1
        ms3 = M.erase_keyframe(ms, jnp.int32(2))
        assert int(M.kf_capacity_left(ms3)) == 1

    def test_free_kf_slot_never_evicts_active(self):
        ms = _populated_ms(k=4)
        ms = ms._replace(kf_map_id=ms.kf_map_id.at[1].set(99))  # dormant
        slot = int(M.free_kf_slot(ms))
        assert slot == 1   # the dormant one, never a live active-map KF


class TestEpochTimestamps:
    def test_time_base_offsets(self):
        """Epoch-scale driver stamps must land as small offsets on device
        and come back as exact absolute times in trajectories."""
        from geoflowslam.pipeline.system import SlamSystem, SystemConfig
        from geoflowslam.state.frame import FrameConfig
        from geoflowslam.ops.extractor import OrbConfig
        from geoflowslam.io.synthetic import (SyntheticWorld,
                                              SyntheticSequence, Camera)
        from geoflowslam.io.trajectory import keyframe_trajectory

        w, h = 160, 120
        cam = Camera(fx=100.0, fy=100.0, cx=w / 2, cy=h / 2, width=w, height=h)
        orb = OrbConfig(n_features=150, n_levels=3, height=h, width=w)
        fc = FrameConfig(orb=orb, lk_levels=2, cloud_stride=8,
                         cloud_max_pts=512, bf=10.0)
        cfg = SystemConfig(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                           bf=10.0, frame=fc, k_max=8, m_max=1024,
                           kf_min_interval=1, kf_max_interval=2)
        world = SyntheticWorld(cam)
        seq = SyntheticSequence(world, fps=10.0)
        slam = SlamSystem(cfg)
        t0 = 1.4e9
        for i in range(6):
            gray, depth, _ = seq.frame(i / 10.0)
            slam.track_rgbd(gray, depth, t0 + i / 10.0)
        assert slam.time_base == t0
        # device-side stamps are small offsets with full precision
        times = np.asarray(slam.ms.kf_time)[np.asarray(slam.ms.kf_valid)]
        assert times.max() < 10.0
        # trajectory exports carry exact absolute stamps
        traj = keyframe_trajectory(slam.ms, time_base=slam.time_base)
        stamps = np.array([t for t, _ in traj])
        frac = (stamps - t0) * 10.0
        assert np.allclose(frac, np.round(frac), atol=1e-3), stamps - t0


class TestLoopConsistency:
    def test_verify_gated_by_temporal_consistency(self, monkeypatch):
        """A single-shot candidate must never reach geometric verification;
        three consecutive consistent detections must (NewDetectCommonRegions'
        >=3 coincidences)."""
        from geoflowslam.pipeline.loop_closing import LoopCloser, LoopConfig
        from geoflowslam.retrieval import vocab as V

        key = jax.random.PRNGKey(4)
        train = jax.random.randint(key, (800, 8), 0, 2**31 - 1,
                                   jnp.int32).astype(jnp.uint32)
        voc = V.build_vocabulary(np.asarray(train), k=8, levels=2, iters=2)
        k, n, m = 12, 32, 256
        ms = M.create(k, n, m)
        base = train[:n]
        # KF 0: the loop target (old, different map region, no covisibility
        # with the queries); KFs 5..8: consecutive query KFs with matching
        # appearance but disjoint observations.
        descs = {0: base}
        for q in (5, 6, 7, 8):
            descs[q] = base  # identical appearance
        for slot in range(9):
            d = descs.get(slot, jax.random.randint(
                jax.random.PRNGKey(slot + 10), (n, 8), 0, 2**31 - 1,
                jnp.int32).astype(jnp.uint32))
            obs = jnp.full((n,), M.NO_MP, jnp.int32)
            ms = M.insert_keyframe(
                ms, jnp.int32(slot), jnp.eye(3), jnp.zeros(3), jnp.zeros(3),
                jnp.zeros(6), jnp.float32(slot * 10.0), jnp.zeros((n, 2)),
                jnp.zeros(n, jnp.int32), jnp.zeros(n), d,
                jnp.full((n,), -1.0), jnp.ones(n, bool), obs, jnp.int32(-1))

        lc = LoopCloser(voc, k, LoopConfig(min_score=0.01,
                                           consistency_needed=3))
        calls = []
        monkeypatch.setattr(
            lc, "_verify_sim3",
            lambda ms_, cur, cand: calls.append((cur, cand)) or
            (False, None, None, None, 0, 0))
        ms, _ = lc.on_keyframe(ms, 0)      # registers the target
        ms, f1 = lc.on_keyframe(ms, 5)     # detection #1 -> no verify yet
        assert not f1 and calls == []
        ms, f2 = lc.on_keyframe(ms, 6)     # detection #2 -> no verify yet
        assert not f2 and calls == []
        ms, f3 = lc.on_keyframe(ms, 7)     # detection #3 -> verify attempted
        assert calls, "3rd consistent detection must reach Sim3 verification"


class TestImuInitVariants:
    def _make(self, scale=2.0):
        from geoflowslam.math import lie
        rng = np.random.RandomState(0)
        K = 10
        g = np.array([0.2, -0.3, -9.79])
        g = g / np.linalg.norm(g) * 9.81
        ba = np.array([0.05, -0.03, 0.08])
        dts = np.full(K - 1, 0.5)
        rots = np.stack([np.asarray(lie.so3_exp(jnp.asarray(rng.randn(3) * 0.6)))
                         for _ in range(K)])
        vels, ps = [np.array([0.3, 0.1, -0.2])], [np.zeros(3)]
        dVs, dPs, JPa, JVa = [], [], [], []
        for i in range(K - 1):
            dt = dts[i]
            a_w = rng.randn(3) * 0.5
            v2 = vels[-1] + a_w * dt
            dV = rots[i].T @ (v2 - vels[-1] - g * dt)
            p2 = ps[-1] + vels[-1] * dt + 0.5 * a_w * dt * dt
            dP = rots[i].T @ (p2 - ps[-1] - vels[-1] * dt - 0.5 * g * dt * dt)
            jva = -np.eye(3) * dt
            jpa = -np.eye(3) * 0.5 * dt * dt
            dVs.append(dV - jva @ ba)
            dPs.append(dP - jpa @ ba)
            JVa.append(jva)
            JPa.append(jpa)
            vels.append(v2)
            ps.append(p2)
        return (rots, np.stack(ps), dts, np.stack(dVs), np.stack(dPs),
                np.stack(JPa), np.stack(JVa), np.stack(vels), g, ba)

    def test_analytic_accelerometer_recovers_bias_scale_gravity(self):
        """IMU.IMUMethod=2 (analytic/MQH accelerometer, methods.h:127,398):
        with rotation diversity the linear solve recovers ba, |g|-constrained
        gravity, and monocular scale exactly on noiseless data."""
        from geoflowslam.solvers import inertial as VI
        rots, ps, dts, dVs, dPs, JPa, JVa, vels, g, ba = self._make()
        v_est, grav, ba_est, scale = VI.solve_accelerometer_analytic(
            jnp.asarray(rots), jnp.asarray(ps / 2.0), jnp.asarray(dts),
            jnp.asarray(dVs), jnp.asarray(dPs), jnp.asarray(JPa),
            jnp.asarray(JVa), jnp.ones(len(dts), bool), solve_scale=True)
        assert abs(float(scale) - 2.0) < 1e-3
        assert np.linalg.norm(np.asarray(ba_est) - ba) < 1e-3
        assert np.linalg.norm(np.asarray(grav) - g) < 1e-3
        assert abs(float(jnp.linalg.norm(grav)) - 9.81) < 1e-4

    def test_scale_refinement(self):
        """LocalMapping::ScaleRefinement: with velocities/bias held, the
        scale-only solve recovers the drifted map scale."""
        from geoflowslam.solvers import inertial as VI
        rots, ps, dts, dVs, dPs, JPa, JVa, vels, g, ba = self._make()
        dV_c = dVs + np.einsum("kij,j->ki", JVa, ba)
        dP_c = dPs + np.einsum("kij,j->ki", JPa, ba)
        s, g2 = VI.solve_scale_refinement(
            jnp.asarray(rots), jnp.asarray(ps / 1.5), jnp.asarray(dts),
            jnp.asarray(dV_c), jnp.asarray(dP_c),
            jnp.asarray(vels[:-1]), g_dir=jnp.asarray(g / 9.81))
        assert abs(float(s) - 1.5) < 1e-3


class TestAsyncGBA:
    def test_microstep_gba_converges_and_propagates(self):
        """Interleaved GBA must reduce reprojection error and carry its
        correction onto a KF inserted while it was running."""
        from geoflowslam.pipeline import local_mapping as LM

        cfg = LM.MappingConfig(fx=100.0, fy=100.0, cx=64.0, cy=48.0, bf=10.0)
        k, n, m = 6, 64, 256
        key = jax.random.PRNGKey(1)
        pts = jax.random.uniform(key, (m, 3), minval=jnp.array([-2, -2, 3.0]),
                                 maxval=jnp.array([2, 2, 8.0]))
        ms = M.create(k, n, m)
        rng = np.random.RandomState(0)
        for s in range(4):
            rot = jnp.eye(3)
            t = jnp.array([0.15 * s, 0.0, 0.0])
            sel = jnp.arange(s * 48, s * 48 + n, dtype=jnp.int32) % m
            pc = pts[sel] @ rot.T + t
            uv = jnp.stack([100.0 * pc[:, 0] / pc[:, 2] + 64.0,
                            100.0 * pc[:, 1] / pc[:, 2] + 48.0], axis=1)
            ms = M.insert_keyframe(
                ms, jnp.int32(s), rot, t, jnp.zeros(3), jnp.zeros(6),
                jnp.float32(s * 0.5), uv, jnp.zeros(n, jnp.int32),
                jnp.zeros(n), jnp.zeros((n, 8), jnp.uint32),
                pc[:, 2], jnp.ones(n, bool), sel, jnp.int32(s - 1))
        ms = ms._replace(
            mp_pos=pts + 0.03 * jnp.asarray(rng.randn(m, 3)),
            mp_valid=jnp.ones(m, bool),
            mp_map_id=jnp.zeros(m, jnp.int32),
            mp_first_kf=jnp.zeros(m, jnp.int32))
        # perturb the later poses
        ms = ms._replace(kf_t=ms.kf_t.at[2].add(jnp.array([0.05, -0.03, 0.02]))
                         .at[3].add(jnp.array([-0.04, 0.05, -0.03])))

        gba = LM.AsyncGBA(cfg, ba_pts=256, iters_total=8)
        gba.start(ms)
        # KF inserted while GBA runs (child of KF 3)
        rot = jnp.eye(3)
        t_child = jnp.array([0.6, 0.0, 0.0])
        sel = jnp.arange(0, n, dtype=jnp.int32)
        ms = M.insert_keyframe(
            ms, jnp.int32(4), rot, t_child, jnp.zeros(3), jnp.zeros(6),
            jnp.float32(2.0), jnp.zeros((n, 2)), jnp.zeros(n, jnp.int32),
            jnp.zeros(n), jnp.zeros((n, 8), jnp.uint32),
            jnp.full((n,), 2.0), jnp.ones(n, bool), sel, jnp.int32(3))
        done = False
        steps = 0
        while not done:
            done = gba.step()
            steps += 1
        assert steps == 8
        t3_before = np.asarray(ms.kf_t[3]).copy()
        child_before = np.asarray(ms.kf_t[4]).copy()
        ms2 = gba.finish(ms)
        # optimized pose moved back toward truth
        err_before = abs(t3_before[0] - 0.45) + abs(t3_before[1]) \
            + abs(t3_before[2])
        t3 = np.asarray(ms2.kf_t[3])
        err_after = abs(t3[0] - 0.45) + abs(t3[1]) + abs(t3[2])
        assert err_after < err_before * 0.6, (err_before, err_after)
        # the mid-run KF moved by its parent's correction (not untouched)
        child_after = np.asarray(ms2.kf_t[4])
        delta_parent = np.asarray(ms2.kf_t[3]) - t3_before
        assert not np.allclose(child_after, child_before, atol=1e-6)
        assert np.allclose(child_after - child_before, delta_parent,
                           atol=5e-2), (child_after - child_before,
                                        delta_parent)

    def test_abort_discards(self):
        from geoflowslam.pipeline import local_mapping as LM
        cfg = LM.MappingConfig()
        ms = _populated_ms(all_mp_valid=True)
        gba = LM.AsyncGBA(cfg, ba_pts=64, iters_total=4)
        gba.start(ms)
        gba.step()
        gba.abort()
        assert not gba.active and not gba.step()
