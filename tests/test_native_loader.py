"""Native C++ loader tests: decode parity vs PIL (PNG) and the numpy PGM
reader, prefetch correctness."""

import numpy as np
import pytest

from coloc_tpu.io import disk, native_loader, synthetic

H, W = 120, 160
K = np.array([[100.0, 0, 80], [0, 100.0, 60], [0, 0, 1]], np.float32)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    folder = str(tmp_path_factory.mktemp("native_ds"))
    scene = synthetic.make_scene(H, W, K, seed=5)
    synthetic.write_dataset(folder, scene, num_drones=2, num_frames=3)
    return folder


pytestmark = pytest.mark.skipif(
    not native_loader.available(), reason="native toolchain unavailable"
)


def test_png_decode_matches_pil(dataset, tmp_path):
    from PIL import Image

    img = disk.load_frame(dataset, 0, 0)
    path = str(tmp_path / "frame.png")
    Image.fromarray(img.astype(np.uint8)).save(path)
    ref = disk.load_image(path)  # PIL path
    out = native_loader.decode_image(path, H, W)
    assert out is not None
    # PNG storage is uint8; both decoders must agree exactly
    np.testing.assert_array_equal(out, ref)


def test_pgm_decode_matches_numpy(dataset):
    path = disk.frame_path(dataset, 1, 2, "pgm")
    out = native_loader.decode_image(path, H, W)
    assert out is not None
    np.testing.assert_array_equal(out, disk.load_image(path))


def test_prefetch_loader_all_frames(dataset):
    with native_loader.NativeLoader(dataset, 2, 3, H, W) as loader:
        for f in range(3):
            for d in range(2):
                img = loader.get(d, f)
                ref = disk.load_frame(dataset, d, f)
                np.testing.assert_array_equal(img, ref)


def test_random_access_fallback(dataset):
    """Out-of-order access must still return correct frames."""
    with native_loader.NativeLoader(dataset, 2, 3, H, W) as loader:
        img = loader.get(1, 2)
        ref = disk.load_frame(dataset, 1, 2)
        np.testing.assert_array_equal(img, ref)


def test_missing_file_errors(dataset):
    with native_loader.NativeLoader(dataset, 2, 10, H, W) as loader:
        img = loader.get(0, 0)  # valid
        assert img.shape == (H, W)
