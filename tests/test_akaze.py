"""AKAZE-MLDB parity path tests (reference CPU backend: CPUDetector.hpp +
AKAZE.hpp): diffusion scale space, detection, orientation, MLDB matching."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from coloc_tpu.config import DetectorOptions, MatcherOptions
from coloc_tpu.frontend import detect_and_describe
from coloc_tpu.matching import match_pair
from coloc_tpu.ops import diffusion
from coloc_tpu.io import synthetic

H, W = 240, 320
K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)
OPTS = DetectorOptions(width=W, height=H, max_keypoints=512, num_levels=8,
                       backend="akaze")


@pytest.fixture(scope="module")
def img():
    scene = synthetic.make_scene(H, W, K, seed=3)
    return synthetic.render(scene, np.eye(3, dtype=np.float32),
                            np.zeros(3, np.float32))


class TestDiffusion:
    def test_fed_cycle_sums_to_time(self):
        for T in (0.5, 3.0, 20.0):
            taus = diffusion.fed_tau_cycle(T)
            assert abs(sum(taus) - T) < 1e-9
            assert all(t > 0 for t in taus)

    def test_diffusion_preserves_mean_and_smooths(self, img):
        sp = diffusion.build_scale_space(jnp.asarray(img), num_octaves=2,
                                         num_sublevels=2)
        base = np.asarray(sp[0].L)
        later = np.asarray(sp[-2].L)  # same octave? take level before downsample
        # diffusion is conservative (flux form): mean approximately preserved
        assert abs(base.mean() - np.asarray(sp[1].L).mean()) < 1e-3
        # and smooths: total variation decreases within the octave
        tv = lambda a: np.abs(np.diff(a, axis=0)).mean() + np.abs(np.diff(a, axis=1)).mean()
        assert tv(np.asarray(sp[1].L)) < tv(base)

    def test_fed_octave_kernel_matches_xla_steps(self, img):
        """The batched scale space (vmapped per-step FED stencils +
        per-sublevel Scharr/Hessian outputs) against a float64 numpy
        evolution of the same schedule, on non-aligned image sizes and a
        batch of two images with distinct contrast factors (edge clamping
        and batch independence must be exact up to f32 rounding)."""
        rng = np.random.default_rng(1)

        def scharr(a):
            p = np.pad(a, 1, mode="edge")
            h, w = a.shape
            s = lambda dy, dx: p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            gx = (3 * (s(-1, 1) - s(-1, -1)) + 10 * (s(0, 1) - s(0, -1))
                  + 3 * (s(1, 1) - s(1, -1))) / 32.0
            gy = (3 * (s(1, -1) - s(-1, -1)) + 10 * (s(1, 0) - s(-1, 0))
                  + 3 * (s(1, 1) - s(-1, 1))) / 32.0
            return gx, gy

        def step(L, g, tau):
            p, gp = np.pad(L, 1, mode="edge"), np.pad(g, 1, mode="edge")
            h, w = L.shape
            s = lambda a, dy, dx: a[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            flux = sum(0.5 * (g + s(gp, dy, dx)) * (s(p, dy, dx) - L)
                       for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)))
            return L + tau * flux

        S, sigma0 = 3, 1.6
        for (h, w) in ((120, 188), (37, 61)):
            imgs = rng.uniform(0, 255, (2, h, w)).astype(np.float32)
            imgs[1] = np.clip(imgs[1] * 0.4, 0, 255)   # other contrast
            levels = diffusion.build_scale_space_batch(
                jnp.asarray(imgs), num_octaves=1, num_sublevels=S,
                sigma0=sigma0)
            for bi in range(2):
                L = imgs[bi].astype(np.float64) / 255.0
                k = float(diffusion.contrast_factor(jnp.asarray(
                    imgs[bi] / np.float32(255.0))))
                t_prev = 0.5 * 0.5 ** 2
                for s_ in range(S):
                    sigma = sigma0 * 2.0 ** (s_ / S)
                    t = 0.5 * sigma * sigma
                    taus = diffusion.fed_tau_cycle(max(t - t_prev, 1e-4))
                    t_prev = t
                    gx, gy = scharr(L)
                    g = 1.0 / (1.0 + (gx * gx + gy * gy) / (k * k))
                    for tau in taus:
                        L = step(L, g, tau)
                    Lx, Ly = scharr(L)
                    Lxx, Lxy = scharr(Lx)
                    _, Lyy = scharr(Ly)
                    resp = sigma ** 4 * (Lxx * Lyy - Lxy * Lxy)
                    ev = levels[s_]
                    for name, got, want in (("L", ev.L, L), ("Lx", ev.Lx, Lx),
                                            ("Ly", ev.Ly, Ly),
                                            ("response", ev.response, resp)):
                        np.testing.assert_allclose(
                            np.asarray(got[bi]), want, rtol=1e-4, atol=2e-5,
                            err_msg=f"{name} level {s_} image {bi} {h}x{w}")

    def test_edge_preservation(self):
        """Perona-Malik: a strong step edge survives diffusion far better
        than the same-amplitude fine texture."""
        rng = np.random.default_rng(0)
        img = np.zeros((64, 96), np.float32)
        img[:, 48:] = 200.0                       # strong edge
        img += rng.uniform(-20, 20, img.shape)    # weak texture
        sp = diffusion.build_scale_space(jnp.asarray(img), num_octaves=1,
                                         num_sublevels=3)
        L = np.asarray(sp[-1].L) * 255.0
        # texture flattened
        assert L[10:50, 5:40].std() < 10.0
        # edge amplitude retained
        assert (L[:, 60:].mean() - L[:, :36].mean()) > 150.0


class TestAkazeFrontend:
    def test_detects_and_fills_bank(self, img):
        f = detect_and_describe(jnp.asarray(img), OPTS)
        assert int(np.asarray(f.valid).sum()) > 100
        assert f.desc.shape == (512, 16)
        # 486-bit descriptor: the padding bits (486..511) must be zero
        bits_hi = np.asarray(f.desc)[:, 15]  # last word holds bits 480..511
        assert (bits_hi >> 6 == 0).all()  # bits 486+ of the word are clear

    def test_batch_equals_single(self, img):
        """The batched AKAZE frontend (vmapped diffusion + vertically stacked
        rasters) must reproduce the single-image path per entry."""
        from coloc_tpu.frontend import detect_and_describe_batch

        rng = np.random.default_rng(7)
        img2 = np.clip(
            img.astype(np.float32) + rng.uniform(-30, 30, img.shape), 0, 255
        )
        imgs = jnp.asarray(np.stack([img, img2]), jnp.float32)
        fb = detect_and_describe_batch(imgs, OPTS)
        for i in range(2):
            f1 = detect_and_describe(imgs[i], OPTS)
            np.testing.assert_array_equal(
                np.asarray(fb.valid[i]), np.asarray(f1.valid)
            )
            v = np.asarray(f1.valid)
            # subpixel offsets add to image-LOCAL coords
            # (ops/fast.subpixel_offsets), so batch position cannot shift
            # coordinates. The batched and single graphs still compile to
            # differently shaped XLA loops, whose vectorized and remainder
            # parts may contract a*b+c into an FMA differently: a response
            # value can differ in its last bit, which moves a subpixel
            # offset by an ulp. So xy agrees to a few ulp, descriptor bits
            # exactly.
            np.testing.assert_array_max_ulp(
                np.asarray(fb.xy[i])[v], np.asarray(f1.xy)[v], maxulp=4
            )
            np.testing.assert_array_equal(
                np.asarray(fb.desc[i])[v], np.asarray(f1.desc)[v]
            )

    def test_translation_matching_ratio_mode(self, img):
        dx, dy = 24, 13
        sh = np.roll(np.roll(img, dy, axis=0), dx, axis=1)
        fa = detect_and_describe(jnp.asarray(img), OPTS)
        fb = detect_and_describe(jnp.asarray(sh), OPTS)
        m = match_pair(fa, fb, MatcherOptions(mode="ratio", dist_ratio=0.8))
        mask = np.asarray(m.mask)
        assert mask.sum() >= 50
        qxy = np.asarray(fa.xy)[mask]
        txy = np.asarray(fb.xy)[np.asarray(m.idx)[mask]]
        d = txy - qxy
        good = (np.abs(d[:, 0] - dx) < 2) & (np.abs(d[:, 1] - dy) < 2)
        assert good.mean() > 0.8

    def test_rotation_matching(self, img):
        rot = np.rot90(img).copy()
        optsr = DetectorOptions(width=H, height=W, max_keypoints=512,
                                num_levels=8, backend="akaze")
        fa = detect_and_describe(jnp.asarray(img), OPTS)
        fr = detect_and_describe(jnp.asarray(rot), optsr)
        m = match_pair(fa, fr, MatcherOptions(mode="ratio", dist_ratio=0.8))
        mask = np.asarray(m.mask)
        assert mask.sum() >= 50
        qxy = np.asarray(fa.xy)[mask]
        txy = np.asarray(fr.xy)[np.asarray(m.idx)[mask]]
        pred = np.stack([qxy[:, 1], W - 1 - qxy[:, 0]], axis=1)
        err = np.linalg.norm(txy - pred, axis=1)
        assert (err < 3).mean() > 0.85


class TestParityUpgrades:
    """Cross-scale extrema suppression + dense-cell MLDB means
    are validated by DOWNSTREAM equivalence — the AKAZE backend must feed the
    same robust-geometry stack as TRIP with comparable inlier yield."""

    def test_no_duplicate_keypoints_at_adjacent_scales(self, img):
        """Cross-scale suppression criterion: the same corner must not
        surface at ADJACENT evolution levels (the reference dedups each
        level against the previous one; detections at distant scales — e.g.
        one octave apart — are genuinely different features and survive in
        the reference too)."""
        f = detect_and_describe(jnp.asarray(img), OPTS)
        xy = np.asarray(f.xy)[np.asarray(f.valid)]
        sc = np.asarray(f.scale)[np.asarray(f.valid)]
        d = np.linalg.norm(xy[:, None] - xy[None, :], axis=-1)
        adjacent = np.abs(sc[:, None] - sc[None, :]) == 1
        dup = (d < 1.5) & adjacent
        np.fill_diagonal(dup, False)
        dup_rate = dup.any(axis=1).mean()
        assert dup_rate < 0.03, f"adjacent-scale duplicate rate {dup_rate:.3f}"

    def test_duplicate_rate_beyond_dedup_cap(self):
        """Cross-scale suppression AT CAPACITY: the
        round-2 implementation capped the pairwise comparison at the 1024
        strongest candidates per level, and this fixture showed a 13%
        duplicate leak beyond the cap; the grid scatter-max suppression
        that replaced it (akaze.py) is O(k) and must hold the duplicate
        rate low at ANY candidate count."""
        # dense grid of random-intensity squares: ~1200 blobs x 4 corners
        # per fine level >> the former 1024-candidate cap
        rng = np.random.default_rng(1)
        big = np.full((480, 640), 64.0, np.float32)
        for by in range(0, 480 - 8, 16):
            for bx in range(0, 640 - 8, 16):
                big[by : by + 8, bx : bx + 8] = rng.uniform(128, 255)
        opts = DetectorOptions(width=640, height=480, max_keypoints=2048,
                               num_levels=4, backend="akaze")
        f = detect_and_describe(jnp.asarray(big), opts)

        n_valid = int(np.asarray(f.valid).sum())
        assert n_valid > 1024, (
            f"fixture too sparse to exercise capacity ({n_valid})"
        )
        xy = np.asarray(f.xy)[np.asarray(f.valid)]
        sc = np.asarray(f.scale)[np.asarray(f.valid)]
        d = np.linalg.norm(xy[:, None] - xy[None, :], axis=-1)
        adjacent = np.abs(sc[:, None] - sc[None, :]) == 1
        dup = (d < 1.5) & adjacent
        np.fill_diagonal(dup, False)
        dup_rate = dup.any(axis=1).mean()
        assert dup_rate < 0.05, (
            f"adjacent-scale duplicate rate {dup_rate:.3f} beyond cap"
        )

    def test_downstream_relative_pose_quality(self, img):
        """Two-view essential RANSAC on AKAZE features: success with an
        inlier yield in the same class as the TRIP backend on one scene."""
        import jax
        from coloc_tpu.config import RansacOptions
        from coloc_tpu.geometry import camera as cam_ops, so3
        from coloc_tpu.io import synthetic
        from coloc_tpu.robust import relative_pose_essential

        h, w = 180, 240
        K = np.array([[0.7 * w, 0, w / 2], [0, 0.7 * w, h / 2], [0, 0, 1]],
                     np.float32)
        cam = cam_ops.Camera(K=jnp.asarray(K), dist=jnp.zeros(3, jnp.float32))
        scene = synthetic.make_scene(h, w, K, seed=21)
        R2 = np.asarray(so3.exp(jnp.asarray([0.008, -0.03, 0.004],
                                            jnp.float32)))
        C2 = np.array([0.25, 0.04, 0.01], np.float32)
        img1 = synthetic.render(scene, np.eye(3, dtype=np.float32),
                                np.zeros(3, np.float32))
        img2 = synthetic.render(scene, R2, C2)

        yields = {}
        for backend, mode in (("akaze", "ratio"), ("trip", "margin")):
            opts = DetectorOptions(width=w, height=h, max_keypoints=256,
                                   num_levels=4, fast_threshold=12,
                                   backend=backend)
            fa = detect_and_describe(jnp.asarray(img1), opts)
            fb = detect_and_describe(jnp.asarray(img2), opts)
            m = match_pair(fa, fb, MatcherOptions(mode=mode))
            uv2 = jnp.asarray(np.asarray(fb.xy)[np.asarray(m.idx)])
            geo = relative_pose_essential(
                jax.random.PRNGKey(0), fa.xy, uv2, m.mask, cam, cam,
                RansacOptions(),
            )
            assert bool(geo.success), backend
            yields[backend] = int(geo.n_inliers)
        # same class: akaze inlier yield within 2.5x of trip on this scene
        assert yields["akaze"] * 2.5 >= yields["trip"] * 0.4 * 2.5
        assert yields["akaze"] >= 25
