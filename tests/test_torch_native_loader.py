"""Port parity: the native C++ loader (io/native_loader.py onto
native/loader.cc) against the JAX package's bindings, on the fixtures of
tests/test_native_loader.py: the same PNGs decode to the same bytes (a
depth decode's grey plane aside, which the port leaves None), the
prefetcher serves them, a bad file raises, and the TUM dataset uses the
native decoder when asked to. The port builds its library into
``build/native/`` at first use; a test skips only where neither package's
library can be built (no C++ compiler or zlib).
"""

import shutil

import numpy as np
import pytest

from amos_slam_tpu.io import native_loader as jnl
from amos_slam_tpu_torch.io import native_loader as tnl



@pytest.fixture(autouse=True)
def native_built():
    """Decided inside the test, not at import: every worker collects the
    same tests."""
    if not (tnl.available() and jnl.available()):
        pytest.skip("native loader cannot be built")


@pytest.fixture(scope="module")
def png_dir(tmp_path_factory):
    from PIL import Image

    rng = np.random.default_rng(0)
    d = tmp_path_factory.mktemp("pngs")
    rgb = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
    Image.fromarray(rgb).save(d / "rgb.png")
    gray = rng.integers(0, 255, (48, 64), dtype=np.uint8)
    Image.fromarray(gray).save(d / "gray.png")
    depth = rng.integers(0, 30000, (48, 64), dtype=np.uint16)
    Image.fromarray(depth).save(d / "depth.png")
    return d, rgb, gray, depth


def same(a, b):
    for x, y in zip(a, b):
        if x is None or y is None:
            assert x is None and y is None
        else:
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("name,kw", [("rgb.png", {}), ("gray.png", {}),
                                     ("depth.png", {"depth_factor": 5000.0, "is_depth": True})])
def test_decode_equals_jax(png_dir, name, kw):
    d, rgb, gray, depth = png_dir
    out = tnl.decode_png(str(d / name), **kw)
    want = jnl.decode_png(str(d / name), **kw)
    if kw.get("is_depth"):
        # a depth frame has no grey plane: the JAX binding's is whatever
        # lies past the empty buffer, the port's is None
        assert out[0] is None
        out, want = out[1:], want[1:]
    same(out, want)
    if name == "rgb.png":
        np.testing.assert_array_equal(out[2], rgb)
    elif name == "gray.png":
        np.testing.assert_array_equal(out[0], gray.astype(np.float32))
    else:
        np.testing.assert_allclose(out[0], depth.astype(np.float32) / 5000.0, atol=1e-6)


def test_prefetch_loader_equals_jax(png_dir):
    d, _, _, _ = png_dir
    items = [(float(i), str(d / "rgb.png"), str(d / "depth.png")) for i in range(12)]
    t = tnl.NativePrefetchLoader(items, n_workers=3, ahead=4)
    j = jnl.NativePrefetchLoader(items, n_workers=3, ahead=4)
    try:
        assert len(t) == 12
        for i in (0, 5, 3, 11, 7):
            a, b = t[i], j[i]
            assert a[3] == b[3] == float(i)
            same(a[:3], b[:3])
        # an index read again is decoded anew (the pool serves each once)
        same(t[7][:3], b[:3])
    finally:
        t.close()
        j.close()


def test_decode_failure_raises(tmp_path):
    p = tmp_path / "junk.png"
    p.write_bytes(b"not a png at all")
    with pytest.raises(RuntimeError):
        tnl.decode_png(str(p))


def test_library_is_built_outside_native(png_dir):
    lib = tnl.library_path()
    assert lib.exists() and lib.parent == tnl.ROOT / "build" / "native"
    assert tnl.ROOT / "native" not in lib.parents
    assert tnl.build() == lib                     # built once, then reused


def test_tum_dataset_uses_native(png_dir, tmp_path):
    from amos_slam_tpu.io.tum import TumRGBDDataset as JTum
    from amos_slam_tpu_torch.io.tum import TumRGBDDataset as TTum

    d, rgb, _, depth = png_dir
    root = tmp_path / "seq"
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    lines = []
    for i in range(4):
        shutil.copy(d / "rgb.png", root / "rgb" / f"{i}.png")
        shutil.copy(d / "depth.png", root / "depth" / f"{i}.png")
        lines.append(f"{i}.0 rgb/{i}.png {i}.0 depth/{i}.png")
    (root / "associations.txt").write_text("\n".join(lines) + "\n")

    ds = TTum(str(root))
    assert ds._native is not None and TTum(str(root), native=False)._native is None
    g, dep, rgb_out, t = ds[2]
    assert t == 2.0
    np.testing.assert_array_equal(rgb_out, rgb)
    np.testing.assert_allclose(dep, depth.astype(np.float32) / 5000.0, atol=1e-6)
    same(ds[2][:3], JTum(str(root))[2][:3])   # read again: decoded anew
