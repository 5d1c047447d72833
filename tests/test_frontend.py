"""Frontend tests: FAST detector response, NMS, descriptor stability under
translation, full detect+describe pipeline (SURVEY.md §4: detector response /
descriptor bits unit tests)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from coloc_tpu.config import DetectorOptions, MatcherOptions
from coloc_tpu.frontend import detect_and_describe
from coloc_tpu.matching import match_pair
from coloc_tpu.ops import fast as fast_ops


def blob_image(rng, h=240, w=320, cell=16):
    """Smooth random blob image with sharp-ish structure: stable FAST corners."""
    coarse = rng.uniform(0, 255, (h // cell, w // cell)).astype(np.float32)
    img = np.asarray(
        jax.image.resize(jnp.asarray(coarse), (h, w), method="nearest")
    )
    return img


class TestFastDetector:
    def test_bright_square_corners(self):
        """A bright square on dark background must fire at its 4 corners."""
        img = np.zeros((64, 64), np.float32)
        img[24:40, 24:40] = 200.0
        score = np.asarray(fast_ops.fast_score_map(jnp.asarray(img), 40.0))
        corners = [(24, 24), (24, 39), (39, 24), (39, 39)]
        for (cy, cx) in corners:
            patch = score[cy - 2 : cy + 3, cx - 2 : cx + 3]
            assert patch.max() > 0, f"no response near corner {(cy, cx)}"
        # flat regions must be silent
        assert score[32, 32] == 0.0
        assert score[5, 5] == 0.0

    def test_edge_not_corner(self):
        """A long straight edge must not fire (needs >= 9 consecutive)."""
        img = np.zeros((64, 64), np.float32)
        img[:, 32:] = 200.0
        score = np.asarray(fast_ops.fast_score_map(jnp.asarray(img), 40.0))
        assert score[10:54, :].max() == 0.0

    def test_nms_single_peak(self):
        score = jnp.zeros((32, 32)).at[10, 10].set(5.0).at[10, 11].set(4.0)
        out = np.asarray(fast_ops.nms3(score))
        assert out[10, 10] == 5.0
        assert out[10, 11] == 0.0

    def test_nms_tie_break(self):
        """Equal neighbors: exactly one survives."""
        score = jnp.zeros((32, 32)).at[10, 10].set(5.0).at[10, 11].set(5.0)
        out = np.asarray(fast_ops.nms3(score))
        assert (out > 0).sum() == 1

    def test_topk_masks_empty(self):
        x, y, s, v = fast_ops.topk_keypoints(jnp.zeros((32, 32)), 16)
        assert not np.asarray(v).any()

    def test_top_k_sorted_matches_lax_top_k(self, rng):
        """The sort-based selection keeps lax.top_k's contract exactly:
        values descending, ties to the lowest index, batched rows."""
        x = jnp.asarray(rng.integers(0, 40, (3, 5000)), jnp.float32)
        got = fast_ops.top_k_sorted(x, 700)
        want = jax.lax.top_k(x, 700)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestPipeline:
    OPTS = DetectorOptions(width=320, height=240, max_keypoints=256,
                           num_levels=4, fast_threshold=30)

    def test_structure_and_determinism(self, rng):
        img = jnp.asarray(blob_image(rng))
        f1 = detect_and_describe(img, self.OPTS)
        f2 = detect_and_describe(img, self.OPTS)
        assert f1.xy.shape == (256, 2)
        assert f1.desc.shape == (256, 16)
        assert np.asarray(f1.valid).sum() > 30
        for a, b in zip(f1, f2):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_coords_in_bounds(self, rng):
        img = jnp.asarray(blob_image(rng))
        f = detect_and_describe(img, self.OPTS)
        xy = np.asarray(f.xy)[np.asarray(f.valid)]
        assert (xy[:, 0] >= 0).all() and (xy[:, 0] < 320).all()
        assert (xy[:, 1] >= 0).all() and (xy[:, 1] < 240).all()

    def test_translation_matching(self, rng):
        """Shifted copy of an image: matched keypoints displace by the shift.

        This is the end-to-end stability check that replaces bit-level CLATCH
        parity (SURVEY.md §7.4.3): descriptors only need to be stable enough
        that 2-NN margin matching recovers correspondence."""
        base = blob_image(rng, 240, 320)
        dx, dy = 24, 13
        shifted = np.roll(np.roll(base, dy, axis=0), dx, axis=1)
        fa = detect_and_describe(jnp.asarray(base), self.OPTS)
        fb = detect_and_describe(jnp.asarray(shifted), self.OPTS)
        m = match_pair(fa, fb, MatcherOptions(mode="margin", pair_margin_threshold=40))
        mask = np.asarray(m.mask)
        assert mask.sum() >= 20, f"too few matches: {mask.sum()}"
        qxy = np.asarray(fa.xy)[mask]
        txy = np.asarray(fb.xy)[np.asarray(m.idx)[mask]]
        d = txy - qxy
        # majority of matches must move by exactly (dx, dy) (integer shift,
        # modulo wrap-around at borders)
        good = (np.abs(d[:, 0] - dx) < 1.5) & (np.abs(d[:, 1] - dy) < 1.5)
        assert good.mean() > 0.7, f"inlier rate {good.mean():.2f}"

    def test_vmap_batch(self, rng):
        imgs = jnp.asarray(np.stack([blob_image(rng), blob_image(rng)]))
        from coloc_tpu.frontend import detect_and_describe_batch
        fb = detect_and_describe_batch(imgs, self.OPTS)
        assert fb.xy.shape == (2, 256, 2)

    def test_batch_equals_single(self, rng):
        """The batched frontend (one vertically-stacked raster, one kernel
        per stage) must reproduce the single-image path
        per entry: the per-level keep-out borders make batch-boundary
        contamination impossible, so results are identical."""
        from coloc_tpu.frontend import detect_and_describe_batch

        imgs = jnp.asarray(np.stack(
            [blob_image(rng), blob_image(rng), blob_image(rng)]
        ))
        fb = detect_and_describe_batch(imgs, self.OPTS)
        for i in range(3):
            f1 = detect_and_describe(imgs[i], self.OPTS)
            np.testing.assert_array_equal(
                np.asarray(fb.valid[i]), np.asarray(f1.valid)
            )
            v = np.asarray(f1.valid)
            # subpixel offsets are computed at raster-global row magnitude
            # in the batched path (row + b*R), so f32 rounding differs by
            # ~1e-4 px between batch positions — immaterial
            np.testing.assert_allclose(
                np.asarray(fb.xy[i])[v], np.asarray(f1.xy)[v], atol=2e-3
            )
            np.testing.assert_array_equal(
                np.asarray(fb.desc[i])[v], np.asarray(f1.desc)[v]
            )

    def test_sample_raster_flat_narrow_window(self, rng):
        """Narrow (pw=128) windows through sample_raster_flat must agree
        with a numpy per-channel nearest-sample lookup: exactly against the
        bf16-rounded source (the documented value quantization of the
        one-hot contraction), and to bf16 precision against the raw f32
        source, out-of-window coordinates clamped."""
        from coloc_tpu.ops import patches as patch_ops

        C, R, WP, pw = 3, 160, 512, 128
        K, NS = 16, 37
        srcs = jnp.asarray(rng.normal(size=(C, R, WP)), jnp.float32)
        src2 = srcs.reshape(-1, WP)
        row0 = jnp.asarray(
            rng.integers(0, (R - patch_ops.PH) // 8 + 1, K) * 8, jnp.int32
        )
        col0 = jnp.asarray(
            rng.integers(0, (WP - pw) // 128 + 1, K) * 128, jnp.int32
        )
        lx = jnp.asarray(rng.uniform(-3, pw + 3, (K, NS)), jnp.float32)
        ly = jnp.asarray(
            rng.uniform(-3, patch_ops.PH + 3, (K, NS)), jnp.float32
        )
        out = patch_ops.sample_raster_flat(
            src2, R, row0, col0, lx, ly, C=C, pw=pw
        )
        ci = np.round(np.clip(np.asarray(lx), 0, pw - 1)).astype(int)
        ri = np.round(
            np.clip(np.asarray(ly), 0, patch_ops.PH - 1)
        ).astype(int)
        r0, c0 = np.asarray(row0), np.asarray(col0)

        def lookup(src):
            return np.stack([
                np.stack([
                    src[c, r0[k] + ri[k], c0[k] + ci[k]] for k in range(K)
                ])
                for c in range(C)
            ])

        srcs_bf16 = np.asarray(srcs.astype(jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_array_equal(np.asarray(out), lookup(srcs_bf16))
        np.testing.assert_allclose(
            np.asarray(out), lookup(np.asarray(srcs)), rtol=5e-3, atol=5e-3
        )
