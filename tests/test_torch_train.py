"""The port's YOLACT training (models/train.py, convert.train_state_from)
against the JAX package's, on the CPU.

Both packages run the same weights: ``yolact_tiny``'s net (a (1, 1, 1, 1)
backbone, 4 classes) with Flax's init drawn by the port (seed 0), carried
to JAX by the JAX package's ``port_state_dict``; the ``bn`` weights also
have every FrozenBN's scale/bias/mean/var drawn at random. Batches are made
from seeded numpy, the images transposed to NCHW for the port.

Cases: ``make_batch`` (the JAX tests' batch: 2 images, 2 boxes and one
pad each); ``shared_best_prior`` (two valid gts with the same best prior,
and a valid gt whose best prior is prior 0 followed by padding, whose best
prior is prior 0 too: the JAX matcher's duplicate scatters, last update
winning, un-force it); ``conf_ties`` (the conf head zeroed, so every
background score ties at the OHEM threshold).

Loss and aux are compared in f32 at 128 px, the training dtype and size:
within 1e-5 relative (measured <= 4.5e-7). Gradients and the 3-step run
are compared in float64 at 64 px: a ReLU net's gradient jumps where a
pre-activation crosses 0, and in f32 the packages' last bits put a unit on
either side now and then (with the ``bn`` weights one unit of the
shared_best_prior case at 128 px: 4.5e-8 in the port, -1.5e-7 in JAX,
which moves a bn1 bias gradient by 1.5e-3 of its max; after such a jump
two f32 runs part further at each step). In float64 each tensor's
gradient is held within 1e-6 of its max |grad|, batch norm's four
included (measured <= 9.3e-8), and after 3 steps from the JAX package's
TrainState the params within 1e-6 of each tensor's max |change| and the
momentum within 1e-6 of its max |value| (measured 6.5e-8 and 1.0e-7).
Those gaps are the port's ``Resize``, which multiplies in f32 whatever the
activations' dtype, as it must to round as XLA does in bf16. f64 JAX
steps cost ~2 s each at 64 px, ~10 s at 128. The positives-only mask term
equals the JAX package's dense formula within 1e-6 relative, its
gradients within 1e-5 of max (f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from amos_slam_tpu.models import train as J
from amos_slam_tpu.models.port_torch import port_state_dict
from amos_slam_tpu.models.yolact import Yolact as JYolact, make_priors
from amos_slam_tpu_torch import convert
from amos_slam_tpu_torch.models import train as T
from amos_slam_tpu_torch.models.resnet import FrozenBN
from amos_slam_tpu_torch.models.segmenter import flax_init_
from amos_slam_tpu_torch.models.yolact import Yolact as TYolact

C, LAYERS = 4, (1, 1, 1, 1)
CASES = ("make_batch", "shared_best_prior", "conf_ties")
F64_SIZE = 64


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_batch(rng, S=128, B=2, G=3):
    """The JAX tests' batch (tests/test_yolact_train.py): 2 boxes and a pad
    per image, rectangle masks at S / 4, as numpy."""
    hp = S // 4
    images = rng.normal(0, 1, (B, S, S, 3)).astype(np.float32)
    boxes = np.zeros((B, G, 4), np.float32)
    labels = np.full((B, G), -1, np.int32)
    masks = np.zeros((B, G, hp, hp), np.float32)
    for b in range(B):
        for g in range(2):
            x1, y1 = rng.uniform(0.1, 0.5, 2)
            w, h = rng.uniform(0.2, 0.4, 2)
            boxes[b, g] = [x1, y1, min(x1 + w, 0.95), min(y1 + h, 0.95)]
            labels[b, g] = rng.integers(0, 3)
            masks[b, g, int(y1 * hp):int((y1 + h) * hp), int(x1 * hp):int((x1 + w) * hp)] = 1.0
    return images, boxes, labels, masks


def case_batch(case, S=128):
    if case == "make_batch":
        return make_batch(np.random.default_rng(0), S)
    if case == "conf_ties":
        return make_batch(np.random.default_rng(4), S)
    # image 0: gts 0 and 1 the same box (one best prior), labels 0 and 2,
    # then a pad; image 1: a top-left box inside prior 0, then two pads
    images, boxes, labels, masks = make_batch(np.random.default_rng(3), S)
    boxes[0, 1], labels[0, 1], masks[0, 1] = boxes[0, 0], 2, masks[0, 0]
    labels[0, 0] = 0
    edge = 16 / S
    boxes[1] = [[0.0, 0.0, edge, edge], [0, 0, 0, 0], [0, 0, 0, 0]]
    labels[1] = [1, -1, -1]
    masks[1] = 0.0
    masks[1, 0, :4, :4] = 1.0
    return images, boxes, labels, masks


def jax_batch(arrays, dtype=jnp.float32):
    images, boxes, labels, masks = arrays
    return J.GTBatch(jnp.asarray(images, dtype), jnp.asarray(boxes, dtype), jnp.asarray(labels),
                     jnp.asarray(masks, dtype))


def torch_batch(arrays, dtype=torch.float32):
    images, boxes, labels, masks = (torch.from_numpy(np.array(a)) for a in arrays)
    return T.GTBatch(images.permute(0, 3, 1, 2).contiguous().to(dtype), boxes.to(dtype), labels,
                     masks.to(dtype))


def jax_match(boxes, labels, priors):
    """The JAX package's matcher, models/train.py:79-91, for one image."""
    priors = jnp.asarray(priors)
    G = boxes.shape[0]
    gt_valid = labels >= 0
    iou = jnp.where(gt_valid[None, :], J._prior_gt_iou(priors, boxes), -1.0)
    best_gt = jnp.argmax(iou, axis=1)
    best_iou = jnp.max(iou, axis=1)
    best_prior = jnp.argmax(iou, axis=0)
    forced = jnp.zeros(len(priors), bool).at[best_prior].set(gt_valid)
    forced_gt = jnp.zeros(len(priors), jnp.int32).at[best_prior].set(
        jnp.where(gt_valid, jnp.arange(G), 0))
    pos = (best_iou > 0.5) | forced
    return pos, jnp.where(forced, forced_gt, best_gt), best_prior


@pytest.fixture(scope="module")
def weights():
    """The port's state_dicts: ``plain`` (Flax's init, batch norm at
    identity), ``bn`` (batch norm drawn at random), ``conf_ties`` (``bn``
    with the conf head zeroed)."""
    model = TYolact(C, LAYERS)
    flax_init_(model, torch.Generator().manual_seed(0))
    plain = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(1)
    for m in model.modules():
        if isinstance(m, FrozenBN):
            n = m.weight.shape[0]
            for buf, (lo, hi) in ((m.weight, (0.5, 1.5)), (m.bias, (-0.5, 0.5)),
                                  (m.running_mean, (-0.5, 0.5)), (m.running_var, (0.5, 2.0))):
                buf.copy_(torch.from_numpy(rng.uniform(lo, hi, n).astype(np.float32)))
    bn = {k: v.clone() for k, v in model.state_dict().items()}
    ties = {k: torch.zeros_like(v) if k.startswith("prediction_layers.0.conf_layer") else v
            for k, v in bn.items()}
    return {"plain": plain, "bn": bn, "conf_ties": ties}


def case_weights(weights, case):
    return weights["conf_ties" if case == "conf_ties" else "bn"]


@pytest.fixture(scope="module")
def jax_f32(weights):
    """JAX's jitted loss (f32, 128 px): (loss, aux) per case."""
    model = JYolact(num_classes=C, backbone_layers=LAYERS)
    loss_fn = jax.jit(lambda p, b: J.multibox_loss(model, p, jnp.asarray(make_priors(128)), b))
    out = {}
    for case in CASES:
        loss, aux = loss_fn(port_state_dict(case_weights(weights, case), LAYERS),
                            jax_batch(case_batch(case)))
        out[case] = (float(loss), {k: float(v) for k, v in aux.items()})
    return out


@pytest.fixture(scope="module")
def jax_f64(weights):
    """JAX's jitted train step in float64 at 64 px (lr 2e-3), and per case
    the gradient read off its first step: optax's first momentum is
    ``g + weight_decay * p``."""
    model = JYolact(num_classes=C, backbone_layers=LAYERS)
    with jax.enable_x64(True):
        init, step = J.make_train_step(model, jnp.asarray(make_priors(F64_SIZE)), lr=2e-3)
        step = jax.jit(step)
        grads = {}
        for case in CASES:
            p = port_state_dict({k: v.double() for k, v in case_weights(weights, case).items()},
                                LAYERS)
            state, _, _ = step(init(p), jax_batch(case_batch(case, F64_SIZE), jnp.float64))
            m1 = convert.train_state_from(state, device="cpu").opt_state
            p0 = convert.yolact_state_dict(p)
            grads[case] = {k: m1[k] - 5e-4 * p0[k] for k in m1}
    return {"init": init, "step": step, "grads": grads}


@pytest.mark.parametrize("case", ("make_batch", "shared_best_prior"))
def test_matcher_equals_jax_scatter(case):
    """pos and gt_idx equal, image by image; the shared-best-prior case
    has its duplicates (and a valid gt un-forced by padding on prior 0)."""
    priors = make_priors(128)
    images, boxes, labels, masks = case_batch(case)
    pos, gt_idx = T._match(torch.from_numpy(priors), torch.from_numpy(boxes),
                           torch.from_numpy(labels), 0.5)
    for b in range(len(boxes)):
        jpos, jidx, best_prior = jax_match(jnp.asarray(boxes[b]), jnp.asarray(labels[b]), priors)
        np.testing.assert_array_equal(pos[b].numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(gt_idx[b].numpy(), np.asarray(jidx))
        if case == "shared_best_prior":
            bp = np.asarray(best_prior)
            if b == 0:
                assert bp[0] == bp[1] and int(np.asarray(jidx)[bp[0]]) == 1
            else:
                assert (bp == 0).all() and not bool(np.asarray(jpos)[0])


@pytest.mark.parametrize("case", CASES)
def test_loss_equals_jax(case, weights, jax_f32):
    loss, aux = T.multibox_loss(TYolact(C, LAYERS), case_weights(weights, case),
                                torch.from_numpy(make_priors(128)), torch_batch(case_batch(case)))
    j_loss, j_aux = jax_f32[case]
    assert abs(float(loss) - j_loss) <= 1e-5 * abs(j_loss), (float(loss), j_loss)
    for k, v in j_aux.items():
        assert abs(float(aux[k]) - v) <= 1e-5 * abs(v), (k, float(aux[k]), v)


@pytest.mark.parametrize("case", CASES)
def test_gradients_equal_jax(case, weights, jax_f64):
    """Every tensor of the dict is differentiated, batch norm's weight,
    bias, running_mean and running_var included (float64, 64 px)."""
    leaves = {k: v.double().requires_grad_() for k, v in case_weights(weights, case).items()}
    loss, _ = T.multibox_loss(TYolact(C, LAYERS), leaves, torch.from_numpy(make_priors(F64_SIZE)),
                              torch_batch(case_batch(case, F64_SIZE), torch.float64))
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    j_grads = jax_f64["grads"][case]
    assert set(grads) == set(j_grads)
    bn = [k for k in grads if k.endswith(("running_mean", "running_var"))]
    assert len(bn) == 2 * 17 and all(float(grads[k].abs().max()) > 0 for k in bn)
    for k, g in grads.items():
        ref = j_grads[k]
        assert g.dtype == ref.dtype == torch.float64
        err = float((g - ref).abs().max())
        assert err <= 1e-6 * float(ref.abs().max()), (k, err, float(ref.abs().max()))


def test_three_steps_from_jax_state_equal_jax(weights, jax_f64):
    """train_state_from(JAX's TrainState) carries params and the momentum
    trace across; 3 steps of both packages on 3 batches agree (float64,
    64 px)."""
    j_state = jax_f64["init"](port_state_dict(
        {k: v.double() for k, v in weights["bn"].items()}, LAYERS))
    _, t_step = T.make_train_step(TYolact(C, LAYERS), torch.from_numpy(make_priors(F64_SIZE)),
                                  lr=2e-3)
    t_state = convert.train_state_from(j_state, device="cpu")
    p0 = {k: v.clone() for k, v in t_state.params.items()}
    assert all(v.dtype == torch.float64 for v in p0.values())
    assert all(float(v.abs().max()) == 0.0 for v in t_state.opt_state.values())
    with jax.enable_x64(True):
        for i in range(3):
            arrays = make_batch(np.random.default_rng(10 + i), F64_SIZE)
            j_state, j_loss, _ = jax_f64["step"](j_state, jax_batch(arrays, jnp.float64))
            t_state, t_loss, _ = t_step(t_state, torch_batch(arrays, torch.float64))
            assert abs(float(t_loss) - float(j_loss)) <= 1e-6 * abs(float(j_loss))
    assert int(t_state.step) == int(j_state.step) == 3
    j_back = convert.train_state_from(j_state, device="cpu")
    for k, p in t_state.params.items():
        ref = j_back.params[k]
        change = float((ref - p0[k]).abs().max())
        if k.startswith("backbone") and "bn" in k or "downsample.1" in k:
            assert change > 0, k      # batch norm's four tensors are stepped
        assert float((p - ref).abs().max()) <= 1e-6 * change, k
        m, m_ref = t_state.opt_state[k], j_back.opt_state[k]
        assert float((m - m_ref).abs().max()) <= 1e-6 * float(m_ref.abs().max()), k


def jax_dense_mask_loss(proto, coef, pos, gt_idx, boxes, masks):
    """The JAX package's mask term, models/train.py:112-128, vmapped."""
    def per_image(proto_i, coef_i, pos_i, idx, boxes_i, masks_i):
        n_pos = jnp.maximum(jnp.sum(pos_i), 1)
        m_pred = jnp.einsum("hwc,pc->phw", proto_i, coef_i)
        m_gt = masks_i[idx]
        bce = optax.sigmoid_binary_cross_entropy(m_pred, m_gt)
        Hp, Wp = proto_i.shape[:2]
        ys = jnp.linspace(0, 1, Hp)[None, :, None]
        xs = jnp.linspace(0, 1, Wp)[None, None, :]
        b = boxes_i[idx]
        inside = ((xs >= b[:, 0, None, None]) & (xs <= b[:, 2, None, None])
                  & (ys >= b[:, 1, None, None]) & (ys <= b[:, 3, None, None]))
        area = jnp.maximum(jnp.sum(inside, axis=(1, 2)), 1)
        m_loss = jnp.sum(bce * inside, axis=(1, 2)) / area
        return jnp.sum(m_loss * pos_i) / n_pos

    return jnp.mean(jax.vmap(per_image)(proto, coef, pos, gt_idx, boxes, masks))


def test_positive_mask_term_equals_dense_formula():
    """On random prototypes, coefficients, positives (one image with none)
    and matches: the value and the gradients wrt proto and coef."""
    rng = np.random.default_rng(5)
    B, P, G, Hp, Wp, K = 3, 300, 4, 20, 24, 32
    proto = rng.normal(0, 1, (B, Hp, Wp, K)).astype(np.float32)
    coef = rng.normal(0, 0.5, (B, P, K)).astype(np.float32)
    pos = rng.random((B, P)) < 0.05
    pos[2] = False
    gt_idx = rng.integers(0, G, (B, P)).astype(np.int32)
    xy = rng.uniform(0, 0.6, (B, G, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.1, 0.4, (B, G, 2))], -1).astype(np.float32)
    masks = (rng.random((B, G, Hp, Wp)) < 0.4).astype(np.float32)

    j_val, (j_gp, j_gc) = jax.value_and_grad(jax_dense_mask_loss, argnums=(0, 1))(
        *(jnp.asarray(a) for a in (proto, coef, pos, gt_idx, boxes, masks)))
    tp, tc = (torch.from_numpy(a).requires_grad_() for a in (proto, coef))
    pos_t = torch.from_numpy(pos)
    n_pos = torch.clamp(pos_t.sum(1), min=1)
    val = T._mask_loss(tp, tc, pos_t, torch.from_numpy(gt_idx).long(), torch.from_numpy(boxes),
                       torch.from_numpy(masks), n_pos).mean()
    gp, gc = torch.autograd.grad(val, (tp, tc))
    assert abs(float(val) - float(j_val)) <= 1e-6 * abs(float(j_val))
    for g, ref in ((gp, j_gp), (gc, j_gc)):
        ref = np.asarray(ref)
        assert float(np.abs(g.numpy() - ref).max()) <= 1e-5 * float(np.abs(ref).max())
    assert float(gc[~pos_t].abs().max()) == 0.0


def test_train_step_decreases_loss(weights):
    """The counterpart of tests/test_yolact_train.py::test_train_step_decreases_loss
    (Flax's init, lr 1e-3, 12 steps on one batch)."""
    init, step = T.make_train_step(TYolact(C, LAYERS), torch.from_numpy(make_priors(128)),
                                   lr=1e-3)
    state = init(weights["plain"])
    batch = torch_batch(case_batch("make_batch"))
    losses = []
    for _ in range(12):
        state, loss, aux = step(state, batch)
        losses.append(float(loss))
        assert all(np.isfinite(float(v)) and float(v) >= 0 for v in aux.values())
    assert np.mean(losses[-4:]) < 0.9 * np.mean(losses[:4]), losses


def test_step_leaves_its_input_state_unchanged(weights):
    init, step = T.make_train_step(TYolact(C, LAYERS), torch.from_numpy(make_priors(128)))
    state = init(weights["plain"])
    before = {k: v.clone() for k, v in state.params.items()}
    new, _, _ = step(state, torch_batch(case_batch("make_batch")))
    assert all(torch.equal(state.params[k], before[k]) for k in before)
    assert all(float(v.abs().max()) == 0.0 for v in state.opt_state.values())
    assert int(state.step) == 0 and int(new.step) == 1
