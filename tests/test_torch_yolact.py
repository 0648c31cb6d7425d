"""The port's YOLACT (models/resnet.py, models/yolact.py, models/port_torch.py,
convert.yolact_state_dict) against the JAX package, on the CPU.

Weights cross through the name maps, in both directions: the JAX package's
``port_state_dict`` reads the port's ``state_dict`` (checked at full width,
shapes only), and ``convert.yolact_state_dict`` is its exact inverse. The
nets then run identical random weights: a Flax init of a (1, 1, 1, 1)
backbone with 11 classes at 128x128, batch 2, with randomized batch-norm
statistics.

Tolerances: raw outputs in f32 within 1e-5 of max |JAX| (measured 2.6e-6).
In bf16 (parameters cast as the JAX segmenter casts them) each op rounds
where XLA's does (batch norm in bf16, the bias a separate add, the resizes
as two products rounded after each): single ops agree bit for bit on
>= 99.99% of elements, the rest by one ulp from another summation order in
the conv, and those ulps grow through the layers: the outputs differ by at
most 4.6e-3 (loc), 4.3e-3 (conf), 1.5e-2 (coef, ~1 bf16 ulp of the
pre-tanh value) and 6.8e-3 (proto) of max |JAX|; held to 2.5e-2. Detection
and masks on identical inputs: valid rows equal (boxes and scores within
1e-6), masks exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amos_slam_tpu.models import yolact as Y
from amos_slam_tpu.models.port_torch import port_state_dict
from amos_slam_tpu_torch.convert import yolact_state_dict
from amos_slam_tpu_torch.models import yolact as TY
from amos_slam_tpu_torch.models.port_torch import load_pth, name_map

LAYERS = (1, 1, 1, 1)
C = 11


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def randomize_bn(tree, rng):
    """Flax params with every FrozenBN's scale/bias/mean/var drawn at
    random, so identity batch norm cannot hide a routing fault."""
    if set(tree) == {"scale", "bias", "mean", "var"}:
        n = tree["scale"].shape

        def draw(lo, hi):
            return rng.uniform(lo, hi, n).astype(np.float32)

        return {"scale": draw(0.5, 1.5), "bias": draw(-0.5, 0.5), "mean": draw(-0.5, 0.5),
                "var": draw(0.5, 2.0)}
    return {k: randomize_bn(v, rng) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def net():
    """The JAX model, its params (numpy leaves), an input batch and the JAX
    outputs in f32 and bf16."""
    model = Y.Yolact(num_classes=C, backbone_layers=LAYERS)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)))
    params = {"params": randomize_bn(jax.device_get(params["params"]),
                                     np.random.default_rng(1))}
    x = np.random.default_rng(2).normal(0, 1, (2, 128, 128, 3)).astype(np.float32)
    apply = jax.jit(model.apply)
    out32 = [np.array(o) for o in apply(params, jnp.asarray(x))]
    p_bf = jax.tree.map(lambda p: jnp.asarray(p).astype(jnp.bfloat16), params)
    out16 = [np.array(o.astype(jnp.float32))
             for o in apply(p_bf, jnp.asarray(x).astype(jnp.bfloat16))]
    return params, x, {torch.float32: out32, torch.bfloat16: out16}


def flat_shapes(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_shapes(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = tuple(v.shape)
    return out


def test_state_dict_names_full_width():
    """ResNet-50, 81 classes: the JAX package's port_state_dict reads the
    port's state_dict into exactly the Flax tree's names and shapes."""
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in TY.Yolact(81).state_dict().items()}
    sd = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    ported = port_state_dict(sd)
    want = jax.eval_shape(Y.Yolact(num_classes=81).init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 64, 64, 3)))
    assert flat_shapes(ported) == flat_shapes(want)
    # and back: yolact_state_dict is the inverse on these names
    assert {k: tuple(v.shape) for k, v in yolact_state_dict(ported).items()} == {
        k: tuple(s) for k, s in shapes.items()}


def test_yolact_state_dict_inverts_port_state_dict(net):
    params, _, _ = net
    sd = yolact_state_dict(params)
    back = port_state_dict({k: v.numpy() for k, v in sd.items()}, LAYERS)
    a, b = jax.tree.leaves_with_path(params), jax.tree.leaves_with_path(back)
    assert [p for p, _ in a] == [p for p, _ in b]
    assert all(np.array_equal(u, v) for (_, u), (_, v) in zip(a, b))
    again = yolact_state_dict(back)
    assert list(again) == list(sd)
    assert all(torch.equal(again[k], sd[k]) for k in sd)
    model = TY.Yolact(C, LAYERS)
    model.load_state_dict(sd)          # strict: the port's own names


def test_load_pth_keeps_the_model_keys(tmp_path):
    """A reference-style checkpoint: wrapped in ``state_dict``, with
    ``num_batches_tracked`` and a training-only head. load_pth returns the
    model's keys only; a missing key raises."""
    sd = TY.Yolact(C, LAYERS).state_dict()
    extra = dict(sd)
    extra["backbone.bn1.num_batches_tracked"] = torch.tensor(7)
    extra["semantic_seg_conv.weight"] = torch.zeros(C - 1, 256, 1, 1)
    torch.save({"state_dict": extra}, tmp_path / "y.pth")
    got = load_pth(str(tmp_path / "y.pth"), LAYERS)
    assert list(got) == [k for _, k in name_map(LAYERS)]
    assert set(got) == set(sd)
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    del extra["fpn.pred_layers.1.bias"]
    torch.save(extra, tmp_path / "bad.pth")
    with pytest.raises(KeyError, match="fpn.pred_layers.1.bias"):
        load_pth(str(tmp_path / "bad.pth"), LAYERS)


@pytest.mark.parametrize("size,count", [(128, 1023), (400, 10077), (550, 19248)])
def test_make_priors_exact(size, count):
    p = TY.make_priors(size)
    assert p.shape == (count, 4)
    np.testing.assert_array_equal(p, Y.make_priors(size))


def test_decode_boxes_and_iou():
    rng = np.random.default_rng(3)
    priors = TY.make_priors(128)
    loc = rng.normal(0, 1, (2, priors.shape[0], 4)).astype(np.float32)
    jb = np.asarray(Y.decode_boxes(jnp.asarray(loc), jnp.asarray(priors)))
    tb = TY.decode_boxes(torch.from_numpy(loc), torch.from_numpy(priors)).numpy()
    np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-6)
    boxes = np.array(jb[0, :200])
    ji = np.asarray(Y._iou_matrix(jnp.asarray(boxes)))
    ti = TY._iou_matrix(torch.from_numpy(boxes)[None])[0].numpy()
    np.testing.assert_allclose(ti, ji, rtol=0, atol=1e-6)
    assert ji.max() > 0.5 and (ji == 0).any()


def valid_rows(det, b=None):
    """The valid rows of a Detections, as numpy (image ``b`` of a batch)."""
    d = [np.asarray(t if b is None else t[b]) for t in det]
    v = d[4]
    return d[0][v], d[1][v], d[2][v], d[3][v]


def assert_detections_equal(tdet, jdets):
    for b, jd in enumerate(jdets):
        tb, ts, tc, tk = valid_rows(tdet, b)
        jb, js, jc, jk = valid_rows(jd)
        assert len(ts) == len(js) > 0
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-6)
        np.testing.assert_allclose(ts, js, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tk, jk)


def test_detect_crafted_case():
    """tests/test_yolact.py's fast-NMS case: of two overlapping same-class
    boxes only the stronger survives, a distant third does."""
    P = 16
    priors = np.tile([[0.5, 0.5, 0.2, 0.2]], (P, 1)).astype(np.float32)
    priors[2] = [0.1, 0.1, 0.1, 0.1]
    loc = np.zeros((P, 4), np.float32)
    loc[1] = [0.05, 0.05, 0.0, 0.0]
    conf = np.full((P, 3), -10.0, np.float32)
    conf[:, 0] = 10.0
    conf[0] = [-10, 8, -10]
    conf[1] = [-10, 6, -10]
    conf[2] = [-10, 7, -10]
    coef = np.zeros((P, Y.PROTO_DIM), np.float32)
    kw = dict(top_k=5, pre_nms=8, conf_th=0.1)
    jd = Y.detect(jnp.asarray(loc), jnp.asarray(conf), jnp.asarray(coef), jnp.asarray(priors), **kw)
    td = TY.detect(*(torch.from_numpy(a)[None] for a in (loc, conf, coef)),
                   torch.from_numpy(priors), **kw)
    assert int(td.valid.sum()) == 2
    assert_detections_equal(td, [jd])


@pytest.mark.parametrize("kw", [dict(), dict(top_k=15, conf_th=0.0)], ids=["defaults", "segmenter"])
def test_detect_on_net_output(net, kw):
    """The JAX net's f32 output (batch 2) through both detections: the
    port's batched call against JAX's per-image one."""
    _, _, outs = net
    loc, conf, coef, _ = outs[torch.float32]
    priors = TY.make_priors(128)
    jdets = [Y.detect(jnp.asarray(loc[b]), jnp.asarray(conf[b]), jnp.asarray(coef[b]),
                      jnp.asarray(priors), **kw) for b in range(2)]
    tdet = TY.detect(torch.from_numpy(loc), torch.from_numpy(conf), torch.from_numpy(coef),
                     torch.from_numpy(priors), **kw)
    assert tdet.boxes.shape == (2, kw.get("top_k", 100), 4)
    assert tdet.classes.dtype == torch.int32
    assert_detections_equal(tdet, jdets)


def test_assemble_masks_exact(net):
    """The same prototypes and detections give the same masks."""
    _, _, outs = net
    loc, conf, coef, proto = outs[torch.float32]
    priors = TY.make_priors(128)
    masks = []
    dets = []
    for b in range(2):
        d = Y.detect(jnp.asarray(loc[b]), jnp.asarray(conf[b]), jnp.asarray(coef[b]),
                     jnp.asarray(priors), top_k=15, conf_th=0.0)
        masks.append(np.asarray(Y.assemble_masks(jnp.asarray(proto[b]), d)))
        dets.append([np.asarray(t) for t in d])
    tdet = TY.Detections(*(torch.from_numpy(np.stack(f)) for f in zip(*dets)))
    tm = TY.assemble_masks(torch.from_numpy(proto), tdet).numpy()
    np.testing.assert_array_equal(tm, np.stack(masks))
    assert 0.01 < tm.mean() < 0.99


@pytest.mark.parametrize("n", [16, 50, 69])
def test_linspace_bits(n):
    np.testing.assert_array_equal(TY.linspace01(n).numpy(), np.asarray(jnp.linspace(0, 1, n)))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2.5e-2)],
                         ids=["f32", "bf16"])
def test_full_net_matches_jax(net, dtype, tol):
    params, x, outs = net
    model = TY.Yolact(C, LAYERS).requires_grad_(False)
    model.load_state_dict(yolact_state_dict(params))
    model = model.to(dtype)
    got = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(dtype))
    for name, t, j in zip(("loc", "conf", "coef", "proto"), got, outs[dtype]):
        t = t.float().numpy()
        assert t.shape == j.shape, name
        rel = np.abs(t - j).max() / np.abs(j).max()
        assert rel < tol, f"{name}: {rel:.2e}"
