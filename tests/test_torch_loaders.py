"""Port parity: the dataset loaders and calibrations (io/tum.py, kitti.py,
euroc.py), and the example mains (amos_slam_tpu_torch/examples/).

The loaders read fabricated directory trees (random PNGs, as
tests/test_dataset_loaders.py makes them) through both packages: every
array equal, every timestamp equal; the calibrations field by field. The
TUM loaders run with ``native=False`` (PIL) here; the native decoders are
held to each other in tests/test_torch_native_loader.py.
The mains: each parses ``--help``; rgbd_tum and mono_tum track three
frames of a rendered 320x240 sequence on the CPU from a reference-style
yaml, and write their trajectories.
"""

import dataclasses
import importlib

import numpy as np
import pytest
from PIL import Image

from amos_slam_tpu.io import euroc as jeuroc, kitti as jkitti, tum as jtum
from amos_slam_tpu_torch.io import euroc as teuroc, kitti as tkitti, synthetic, tum as ttum

EXAMPLES = ["rgbd_tum", "stereo_kitti", "stereo_euroc", "mono_tum", "mono_kitti", "mono_euroc"]


def same_items(a, b):
    assert len(a) == len(b) > 0
    for i in range(len(a)):
        for x, y in zip(a[i], b[i]):
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and x.shape == y.shape
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y


@pytest.fixture()
def kitti_dir(tmp_path):
    rng = np.random.default_rng(0)
    seq = tmp_path / "00"
    for cam in ("image_0", "image_1"):
        (seq / cam).mkdir(parents=True)
        for i in range(3):
            Image.fromarray(rng.integers(0, 255, (376, 1241), dtype=np.uint8)).save(
                seq / cam / f"{i:06d}.png")
    (seq / "times.txt").write_text("0.0\n0.1\n0.2\n")
    return seq


def test_kitti_loader_and_calibration(kitti_dir):
    same_items(tkitti.KittiStereoDataset(str(kitti_dir)),
               jkitti.KittiStereoDataset(str(kitti_dir)))
    for seq in (0, 2, 3, 4, 12):
        assert (dataclasses.asdict(tkitti.kitti_camera_config(seq))
                == dataclasses.asdict(jkitti.kitti_camera_config(seq)))
    assert tkitti.KITTI_CALIB == jkitti.KITTI_CALIB


@pytest.mark.parametrize("with_csv", [True, False])
def test_euroc_loader_and_calibration(tmp_path, with_csv):
    rng = np.random.default_rng(1)
    data = tmp_path / "mav0" / "cam1" / "data"
    data.mkdir(parents=True)
    lines = ["#timestamp [ns],filename"]
    for i in range(3):
        ts = 1403636579763555584 + i * 50000000
        Image.fromarray(rng.integers(0, 255, (480, 752), dtype=np.uint8)).save(data / f"{ts}.png")
        lines.append(f"{ts},{ts}.png")
    if with_csv:
        (tmp_path / "mav0" / "cam1" / "data.csv").write_text("\n".join(lines))
    same_items(teuroc.EurocMonoDataset(str(tmp_path), cam="cam1"),
               jeuroc.EurocMonoDataset(str(tmp_path), cam="cam1"))
    assert (dataclasses.asdict(teuroc.euroc_camera_config())
            == dataclasses.asdict(jeuroc.euroc_camera_config()))


def tum_tree(root, n, planes=None, poses=None, associations=True):
    """A TUM sequence directory: rgb/ and depth/ PNGs (depth in 1/5000 m)
    with rgb.txt and depth.txt, and optionally associations.txt. Rendered
    frames if ``planes`` is given, random ones otherwise."""
    rng = np.random.default_rng(2)
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    rgb_lines, depth_lines, assoc = [], [], []
    for i in range(n):
        t_rgb, t_d = 1.0 + i / 30.0, 1.0 + i / 30.0 + 0.004
        if planes is None:
            rgb = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
            depth = rng.integers(0, 40000, (48, 64)).astype(np.uint16)
        else:
            g, d = synthetic.render(planes, poses[i], fx=267.7, fy=269.6, cx=160.05, cy=123.8,
                                    width=320, height=240)
            rgb = np.repeat(np.clip(g, 0, 255).astype(np.uint8)[..., None], 3, -1)
            depth = np.round(d * 5000).astype(np.uint16)
        Image.fromarray(rgb).save(root / "rgb" / f"{t_rgb:.6f}.png")
        Image.fromarray(depth).save(root / "depth" / f"{t_d:.6f}.png")
        rgb_lines.append(f"{t_rgb:.6f} rgb/{t_rgb:.6f}.png")
        depth_lines.append(f"{t_d:.6f} depth/{t_d:.6f}.png")
        assoc.append(f"{t_rgb:.6f} rgb/{t_rgb:.6f}.png {t_d:.6f} depth/{t_d:.6f}.png")
    (root / "rgb.txt").write_text("# rgb\n" + "\n".join(rgb_lines) + "\n")
    (root / "depth.txt").write_text("# depth\n" + "\n".join(depth_lines) + "\n")
    if associations:
        (root / "associations.txt").write_text("\n".join(assoc) + "\n")
    return root


@pytest.mark.parametrize("associations", [True, False])
def test_tum_loader(tmp_path, associations):
    root = tum_tree(tmp_path / "seq", 4, associations=associations)
    tds = ttum.TumRGBDDataset(str(root), native=False)
    same_items(tds, jtum.TumRGBDDataset(str(root), native=False))
    assert len(tds) == 4
    rgb = np.random.default_rng(3).integers(0, 255, (5, 7, 3), dtype=np.uint8)
    for order in (True, False):
        np.testing.assert_array_equal(ttum.rgb_to_gray(rgb, order), jtum.rgb_to_gray(rgb, order))
    pairs = [(0.0, "a"), (0.05, "b"), (0.1, "c")]
    assert ttum.associate(pairs, [(0.01, "x"), (0.09, "y")]) == jtum.associate(
        pairs, [(0.01, "x"), (0.09, "y")])


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_main_help(name, capsys):
    mod = importlib.import_module(f"amos_slam_tpu_torch.examples.{name}")
    with pytest.raises(SystemExit) as e:
        mod.main(["--help"])
    assert e.value.code == 0
    assert "--device" in capsys.readouterr().out


SMALL_YAML = """%YAML:1.0
Camera.fx: 267.7
Camera.fy: 269.6
Camera.cx: 160.05
Camera.cy: 123.8
Camera.width: 320
Camera.height: 240
ORBextractor.nFeatures: 500
ORBextractor.nLevels: 4
"""


@pytest.mark.parametrize("name", ["rgbd_tum", "mono_tum"])
def test_example_main_runs(tmp_path, name, capsys):
    poses = synthetic.orbit_trajectory(3, radius=0.05, advance=0.05)
    root = tum_tree(tmp_path / "seq", 3, synthetic.default_room(seed=1), poses)
    (tmp_path / "small.yaml").write_text(SMALL_YAML)
    out = tmp_path / "traj.txt"
    args = [str(root), "--yaml", str(tmp_path / "small.yaml"), "--out", str(out),
            "--device", "cpu"]
    if name == "rgbd_tum":
        args.append("--no-dynamics")
    importlib.import_module(f"amos_slam_tpu_torch.examples.{name}").main(args)
    assert "median" in capsys.readouterr().out
    rows = [line.split() for line in out.read_text().splitlines() if line.strip()]
    # rgbd_tum writes every frame; mono_tum its keyframes (three frames of a
    # small motion may not initialize a monocular map yet)
    if name == "rgbd_tum":
        assert len(rows) == 3
    assert all(len(r) == 8 for r in rows)


def test_warp_replay_equals_jax(tmp_path, monkeypatch):
    """io.warp_replay on a synthetic texture (the reference's real frames
    are not in the repository): the plane replay and the real-texture room
    built from PNGs in a directory equal the JAX package's."""
    import types

    from amos_slam_tpu.io import warp_replay as jwr
    from amos_slam_tpu_torch.io import warp_replay as twr

    rng = np.random.default_rng(4)
    tex = synthetic._block_texture(rng, size=64).astype(np.float32)
    tex = np.kron(tex, np.ones((2, 2), np.float32))[:96, :128]
    cam = types.SimpleNamespace(fx=120.0, fy=118.0, cx=64.0, cy=48.0)
    poses = synthetic.orbit_trajectory(3, radius=0.05, advance=0.1)
    for (tg, td), (jg, jd) in zip(twr.plane_replay_sequence(tex, cam, poses),
                                  jwr.plane_replay_sequence(tex, cam, poses)):
        np.testing.assert_array_equal(tg, jg)
        np.testing.assert_array_equal(td, jd)
        assert tg.dtype == np.float32 and (td > 0).mean() > 0.5

    monkeypatch.setattr(twr, "REF_INPUT_DIR", str(tmp_path / "absent"))
    assert twr.load_reference_frame() is None and twr.real_room(0) is None
    for i in range(2):
        img = rng.integers(0, 255, (300, 320), dtype=np.uint8)
        Image.fromarray(img).save(tmp_path / f"{i}.png")
    monkeypatch.setattr(twr, "REF_INPUT_DIR", str(tmp_path))
    monkeypatch.setattr(jwr, "REF_INPUT_DIR", str(tmp_path))
    np.testing.assert_array_equal(twr.load_reference_frame(str(tmp_path / "1.png")),
                                  jwr.load_reference_frame(str(tmp_path / "1.png")))
    tr, jr = twr.real_room(seed=3), jwr.real_room(seed=3)
    assert len(tr) == len(jr) == 6
    for a, b in zip(tr, jr):
        assert (a.axis, a.value, a.bounds, a.tex_scale) == (b.axis, b.value, b.bounds, b.tex_scale)
        np.testing.assert_array_equal(a.texture, b.texture)
    (tp, ti), (jp, ji) = twr.real_room_with_mover(1, t=0.5), jwr.real_room_with_mover(1, t=0.5)
    assert ti == ji == 6 and tp[ti].tex_anchor == jp[ji].tex_anchor
    np.testing.assert_array_equal(tp[ti].texture, jp[ji].texture)
