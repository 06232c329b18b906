"""Native C++ radar loader: build, decode parity with PIL, prefetch order."""
import os

import numpy as np
import pytest

from tbv_slam_public_tpu.io import native_loader, oxford



@pytest.fixture(autouse=True)
def _native_library():
    """Build/load the library when a test runs, never at import: the
    answer must not depend on which test worker imported the module."""
    if not native_loader.available():
        pytest.skip("native toolchain unavailable")


def _write_pngs(tmp_path, n=12, rows=64, cols=96, meta_cols=11, seed=0):
    from PIL import Image

    rng = np.random.default_rng(seed)
    radar = tmp_path / "radar"
    radar.mkdir()
    truth = []
    for i in range(n):
        img = rng.integers(0, 255, (rows, meta_cols + cols),
                           dtype=np.uint8)
        stamp_us = 1_000_000 * (i + 1)
        Image.fromarray(img).save(radar / f"{stamp_us:016d}.png")
        truth.append((stamp_us * 1e-6, img[:, meta_cols:].copy()))
    return radar, truth


def test_decode_matches_pil(tmp_path):
    radar, truth = _write_pngs(tmp_path)
    files = sorted(os.listdir(radar))
    img = native_loader.decode_png(str(radar / files[0]), strip_cols=11)
    np.testing.assert_array_equal(img, truth[0][1])
    # PIL path through the oxford reader agrees
    pil_img = oxford.load_oxford_scan(str(radar / files[0]))
    np.testing.assert_array_equal(img, pil_img)


def test_prefetching_reader_order(tmp_path):
    radar, truth = _write_pngs(tmp_path, n=20)
    files = [(s, str(radar / f"{int(s * 1e6):016d}.png")) for s, _ in truth]
    reader = native_loader.NativeSequenceReader(files, strip_cols=11,
                                                num_threads=4,
                                                prefetch_depth=4)
    got = list(reader)
    reader.close()
    assert len(got) == 20
    for (img, stamp), (t_stamp, t_img) in zip(got, truth):
        assert abs(stamp - t_stamp) < 1e-9
        np.testing.assert_array_equal(img, t_img)


def test_reader_survives_missing_file(tmp_path):
    radar, truth = _write_pngs(tmp_path, n=5)
    files = [(s, str(radar / f"{int(s * 1e6):016d}.png")) for s, _ in truth]
    files.insert(2, (2.5, str(radar / "does_not_exist.png")))
    reader = native_loader.NativeSequenceReader(files, strip_cols=11)
    got = list(reader)
    reader.close()
    assert len(got) == 5  # bad frame skipped, order preserved
