"""Fusion tests: Kalman bank with chi-square gating, ICI fusion
(SURVEY.md §4: 'covariance-intersection omega optimum vs closed-form scan')."""

import jax.numpy as jnp
import numpy as np
import pytest

from coloc_tpu.config import FilterOptions
from coloc_tpu.fusion import covint, kalman
from coloc_tpu.geometry import so3
from coloc_tpu.types import Pose

OPTS = FilterOptions()


class TestKalman:
    def test_converges_to_constant_measurement(self):
        bank = kalman.init(2, OPTS)
        pose = Pose(R=so3.euler_to_rot(jnp.asarray([0.1, 0.2, 0.3])),
                    C=jnp.asarray([1.0, 2.0, 3.0]))
        z = kalman.fill_measurement(pose)
        for _ in range(20):
            bank, filtered, dist, rej = kalman.update(
                bank, jnp.int32(0), z, jnp.eye(3) * 0.01, jnp.float32(1.0),
                jnp.asarray(True), OPTS,
            )
        np.testing.assert_allclose(np.asarray(filtered.C), [1, 2, 3], atol=1e-2)
        np.testing.assert_allclose(
            np.asarray(so3.rot_to_euler(filtered.R)), [0.1, 0.2, 0.3], atol=1e-2
        )
        # only drone 0 was touched
        np.testing.assert_array_equal(np.asarray(bank.x[1]), np.zeros(6))

    def test_gate_rejects_jump(self):
        """A wild measurement after convergence is gated; filter coasts."""
        bank = kalman.init(1, OPTS)
        z_good = jnp.asarray([1.0, 1.0, 1.0, 0.0, 0.0, 0.0])
        for _ in range(15):
            bank, filtered, dist, rej = kalman.update(
                bank, jnp.int32(0), z_good, jnp.eye(3) * 0.01,
                jnp.float32(1.0), jnp.asarray(True), OPTS,
            )
        x_before = np.asarray(bank.x[0]).copy()
        z_bad = jnp.asarray([50.0, -40.0, 30.0, 2.0, -2.0, 2.0])
        bank, filtered, dist, rej = kalman.update(
            bank, jnp.int32(0), z_bad, jnp.eye(3) * 0.01,
            jnp.float32(1.0), jnp.asarray(True), OPTS,
        )
        assert bool(rej)
        np.testing.assert_allclose(np.asarray(bank.x[0]), x_before, atol=1e-6)

    def test_no_measurement_coasts(self):
        bank = kalman.init(1, OPTS)
        z = jnp.asarray([1.0, 1.0, 1.0, 0.0, 0.0, 0.0])
        bank, f1, _, _ = kalman.update(
            bank, jnp.int32(0), z, jnp.eye(3) * 0.01, jnp.float32(1.0),
            jnp.asarray(True), OPTS,
        )
        x_before = np.asarray(bank.x[0]).copy()
        bank, f2, _, _ = kalman.update(
            bank, jnp.int32(0), z * 100, jnp.eye(3) * 0.01, jnp.float32(1.0),
            jnp.asarray(False), OPTS,  # no measurement available
        )
        np.testing.assert_allclose(np.asarray(bank.x[0]), x_before, atol=1e-6)


class TestCovInt:
    def test_omega_matches_grid_scan(self, rng):
        """Golden-section optimum vs brute-force scan of the ICI trace."""
        for _ in range(5):
            A = rng.normal(size=(3, 3)); CA = A @ A.T + 0.5 * np.eye(3)
            B = rng.normal(size=(3, 3)); CB = B @ B.T + 0.5 * np.eye(3)
            a = rng.normal(size=3); b = rng.normal(size=3)
            res = covint.fuse(
                jnp.asarray(CA, jnp.float32), jnp.asarray(CB, jnp.float32),
                jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32),
            )
            ws = np.linspace(0, 1, 2001)
            CAi, CBi = np.linalg.inv(CA), np.linalg.inv(CB)
            def trace_at(w):
                M = np.linalg.inv(w * CA + (1 - w) * CB)
                return np.trace(np.linalg.inv(CAi + CBi - M))
            traces = np.array([trace_at(w) for w in ws])
            w_best = ws[np.argmin(traces)]
            # reference eps is 1e-3; golden section gets much tighter, but the
            # objective can be extremely flat — compare trace values
            assert float(res.trace) <= traces.min() + 1e-3 * abs(traces.min())

    def test_identical_inputs(self, rng):
        """CA == CB: fused covariance must not be more confident than the
        inputs (the ICI consistency property), position = a (= b)."""
        A = rng.normal(size=(3, 3)); CA = (A @ A.T + 0.5 * np.eye(3)).astype(np.float32)
        a = rng.normal(size=3).astype(np.float32)
        res = covint.fuse(jnp.asarray(CA), jnp.asarray(CA), jnp.asarray(a), jnp.asarray(a))
        np.testing.assert_allclose(np.asarray(res.pos), a, atol=1e-4)
        evals = np.linalg.eigvalsh(np.asarray(res.cov) - CA + 1e-5 * np.eye(3))
        assert (evals > -1e-3).all()

    def test_fused_between_estimates(self, rng):
        """With one tight and one loose estimate, fusion leans to the tight one."""
        CA = np.eye(3, dtype=np.float32) * 0.01
        CB = np.eye(3, dtype=np.float32) * 10.0
        a = np.array([1.0, 0, 0], np.float32)
        b = np.array([5.0, 0, 0], np.float32)
        res = covint.fuse(jnp.asarray(CA), jnp.asarray(CB), jnp.asarray(a), jnp.asarray(b))
        assert abs(float(res.pos[0]) - 1.0) < 0.1


class TestGateCharacterization:
    """Pin the gate's behavior on nominal vs outlier
    measurements with realistic BA covariances.

    Energy gate (reference parity, innv^T S innv at threshold 10 with
    Q=1e-2/R=1e-1): steady-state S eigenvalues ~0.15, so nominal innovations
    score ~0.1 and only multi-meter teleports reach 10 — a gross-outlier
    rejector. Mahalanobis mode (innv^T S^-1 innv): 10 ~ the chi2(6) 88th
    percentile — a genuinely selective statistical gate.
    """

    def _run_stream(self, opts, z_stream, cov_center, rmse=1.0):
        bank = kalman.init(1, opts)
        dists, rejects = [], []
        for z in z_stream:
            bank, pose, dist, rej = kalman.update(
                bank, jnp.int32(0), jnp.asarray(z, jnp.float32),
                jnp.asarray(cov_center, jnp.float32), jnp.float32(rmse),
                jnp.asarray(True), opts,
            )
            dists.append(float(dist))
            rejects.append(bool(rej))
        return np.asarray(dists), np.asarray(rejects), bank

    def _nominal_stream(self, rng, n=40, sigma=0.05):
        # slowly drifting pose with realistic localization jitter
        base = np.array([1.0, 0.5, -0.3, 0.1, -0.05, 0.2])
        zs = []
        for i in range(n):
            zs.append(base + 0.002 * i + rng.normal(0, sigma, 6))
        return zs

    def test_energy_gate_accepts_all_nominal(self, rng):
        opts = FilterOptions()  # reference values, energy mode
        cov = np.eye(3) * 1e-4  # realistic tight BA covariance
        dists, rejects, _ = self._run_stream(
            opts, self._nominal_stream(rng), cov)
        assert not rejects.any()
        # nominal energy-gate scores sit orders of magnitude under 10
        assert dists[kalman.WARMUP_STEPS:].max() < 1.0

    def test_energy_gate_rejects_teleport_only(self, rng):
        opts = FilterOptions()
        cov = np.eye(3) * 1e-4
        zs = self._nominal_stream(rng)
        zs[20] = zs[19] + np.array([2.0, 0, 0, 0, 0, 0])   # 2 m jump: passes
        zs[30] = zs[29] + np.array([12.0, 0, 0, 0, 0, 0])  # 12 m teleport
        dists, rejects, _ = self._run_stream(opts, zs, cov)
        assert not rejects[20]          # energy gate is NOT selective at 2 m
        assert rejects[30]              # but kills the gross teleport
        assert rejects.sum() == 1

    def test_mahalanobis_gate_is_selective(self, rng):
        opts = FilterOptions(gate_mode="mahalanobis")
        cov = np.eye(3) * 1e-4
        zs = self._nominal_stream(rng)
        zs[25] = zs[24] + np.array([1.5, 0, 0, 0, 0, 0])   # 1.5 m jump
        dists, rejects, _ = self._run_stream(opts, zs, cov)
        assert rejects[25]              # moderate outlier now caught
        # nominal acceptance stays high (chi2(6) at 10 ~ 88th percentile)
        nominal = np.ones(len(zs), bool)
        nominal[25] = False
        nominal[: kalman.WARMUP_STEPS] = False
        assert rejects[nominal].mean() < 0.3

    def test_identity_pose_failure_innovation_is_gated(self, rng):
        """The session logs identity poses on localization failure
        (coloc.hpp:246-257). If such a pose ever reached the filter as a
        measurement while the drone is far from origin, the energy gate
        rejects it (|innv| ~ |position| > sqrt(10/0.15))."""
        opts = FilterOptions()
        cov = np.eye(3) * 1e-4
        base = np.array([10.0, 5.0, -3.0, 0.1, -0.05, 0.2])
        zs = [base + rng.normal(0, 0.05, 6) for _ in range(20)]
        zs[15] = np.zeros(6)            # identity-pose glitch
        dists, rejects, _ = self._run_stream(opts, zs, cov)
        assert rejects[15]
        assert rejects.sum() == 1
