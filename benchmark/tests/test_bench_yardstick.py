"""The yardstick against the program's own arithmetic: the analytic FLOP
count against torch's FLOP counter on the port's YOLACT, the bytes bound
against ``timing.bound``, the renderer against ``io/synthetic.render``,
and the references against the port's plain versions."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import scene
from benchmark.reference import fast as fast_ref
from benchmark.reference import yolact as yolact_ref
from benchmark.weights import yolact_params
from benchmark.yardstick import bytes as ybytes
from benchmark.yardstick.flops import yolact_conv_flops, yolact_flops_per_image


@pytest.mark.parametrize("img_size,num_classes", [(550, 81), (400, 81), (128, 4)])
def test_conv_flops_match_the_flop_counter(img_size, num_classes):
    from amos_slam_tpu_torch.models.yolact import Yolact

    with torch.device("meta"):
        model = Yolact(num_classes=num_classes)
        x = torch.empty(1, 3, img_size, img_size)
    with FlopCounterMode(display=False) as fc:
        model(x)
    counted = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    assert yolact_flops_per_image(img_size, num_classes) == counted["aten.convolution"]
    parts = yolact_conv_flops(img_size, num_classes)
    assert set(parts) == {"backbone", "fpn", "proto_net", "prediction_layers"}


def test_param_shapes_are_the_ports_state_dict():
    from amos_slam_tpu_torch.models.yolact import Yolact

    with torch.device("meta"):
        sd = Yolact().state_dict()
    assert yolact_ref.param_shapes() == {k: tuple(v.shape) for k, v in sd.items()}


@pytest.mark.parametrize("shape", [(8, 480, 640), (64, 480, 640), (8, 376, 1241)])
def test_fast_bytes_match_timing_bound(shape):
    from amos_slam_tpu_torch.ops.kernels import timing

    B, H, W = shape
    sizes = fast_ref.level_sizes(W, H, 1.2, 8)
    r, w = ybytes.fast_launch_bytes(B // 8, sizes, H, W)
    read_px = B // 8 * sum(h * w for h, w in sizes)
    assert ybytes.bound(r, w, 0.0) == timing.bound(4 * read_px, 4 * B * H * W, 0.0)
    assert ybytes.fast_launch_ms(B // 8, sizes, H, W) == timing.bound(r, w, 0.0)[0]


def test_level_sizes_are_the_ports():
    from amos_slam_tpu_torch.config import ORBConfig

    orb = ORBConfig()
    assert fast_ref.level_sizes(640, 480, orb.scale_factor, orb.n_levels) == \
        orb.level_sizes(640, 480)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-4), (torch.float32, 0.05)])
def test_renderer_matches_io_synthetic(dtype, tol):
    from amos_slam_tpu_torch.io import synthetic

    gen = torch.Generator().manual_seed(3)
    planes = scene.room(gen)
    n = 48
    poses = scene.handheld_path(n, 30.0, 0.208, 5.49)
    planes.append(scene.mover(gen, scene.back_and_forth(n, 30.0, 1.2, -1.6, 0.9)))
    cam = dict(fx=535.4 / 4, fy=539.2 / 4, cx=320.1 / 4, cy=247.6 / 4, width=160, height=120)
    idx = np.array([0, 17, 47])
    gray, depth = scene.render(planes, poses[idx], idx, dtype=dtype, **cam)

    def const(v, i):
        return tuple(v[i].tolist()) if isinstance(v, torch.Tensor) else v

    for j, i in enumerate(idx):
        ref = [synthetic.Plane(p.axis, p.value, const(p.bounds, i), p.texture.numpy(),
                               p.tex_scale, tex_anchor=const(p.anchor, i)) for p in planes]
        g, d = synthetic.render(ref, poses[i], **cam)
        close = np.abs(gray[j].double().numpy() - g) <= tol
        assert close.mean() > 0.999
        assert np.abs(depth[j].double().numpy() - d).max() < 1e-4


def test_path_has_the_traffic_speeds():
    Twc = np.linalg.inv(scene.handheld_path(864, 30.0, 0.208, 5.49))
    v, w = scene._speeds(Twc, 30.0)
    assert v == pytest.approx(0.208, rel=1e-6)
    assert w == pytest.approx(5.49, rel=1e-6)
    assert list(scene.playback([0, 863, 864, 1725, 1726], 864)) == [0, 863, 862, 1, 0]


def test_fast_reference_matches_the_ports_plain_version():
    from amos_slam_tpu_torch.ops import pyramid
    from amos_slam_tpu_torch.ops.kernels.fast_margin_nms import fast_margin_nms_plain

    gen = torch.Generator().manual_seed(1)
    gray = (scene.block_textures(gen, 1, size=256)[0, :120, :160]).floor()
    sizes = fast_ref.level_sizes(160, 120, 1.2, 4)
    pyr = pyramid.build_pyramid(gray, sizes)
    ext = torch.tensor(sizes, dtype=torch.int32)
    port = fast_margin_nms_plain(pyr, ext)
    ref = fast_ref.responses(gray, sizes)
    # level 0 is the grey image itself: equal bit for bit
    assert torch.equal(port[0], ref[0])
    bad, either = fast_ref.mismatch(port, ref)
    assert either > 100 and bad / either < 0.01
    # on the program's own pyramid the margins and NMS agree exactly
    ys, xs = torch.arange(120)[:, None], torch.arange(160)[None, :]
    inside = torch.stack([(ys < h) & (xs < w) for h, w in sizes])
    on_port = fast_ref.nms3x3(fast_ref.fast_margin(pyr)) * inside
    assert torch.equal(on_port, port)


def test_yolact_reference_matches_the_ports_net_in_f32():
    from amos_slam_tpu_torch.models.segmenter import Segmenter

    params = yolact_params(5, 81, (3, 4, 6, 3), "cpu", torch.float32)
    seg = Segmenter(params, compute_dtype=torch.float32, img_size=64, device="cpu")
    gen = torch.Generator().manual_seed(2)
    rgb = (torch.rand(2, 48, 64, 1, generator=gen) * 255).floor().expand(-1, -1, -1, 3)
    got = seg.raw(rgb)
    ref = yolact_ref.forward(params, rgb, 64)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert float((g - r).norm() / r.norm()) < 1e-4
