"""The port's YOLACT training step (models/train.py: ``make_train_step``,
``value_and_grads``, ``sgd_update``) against the benchmark's plain
reference (``benchmark/reference/yolact_train.py``), on the CPU.

Both run the same weights and batches: ``benchmark.weights.yolact_params``
from a seed at 81 classes on a (1, 1, 1, 1) backbone (every tensor of the
net drawn, batch norm's four included), and batches of 2 made by the
port's data path from ``SyntheticShapes`` (up to 14 shapes) through
``AugmentConfig()``. Each case runs from the first state (momentum 0) and
from the state after one step (momentum set).

* Loss and its three parts, f32 at 128 px, the training dtype: within
  1e-5 relative. The two sides sum in different orders (the port over the
  batch's padded positives, the reference image by image), so they part at
  f32 rounding (~1e-7), far under 1e-5.
* Gradients and the step, float64 at 64 px: each tensor's gradient within
  1e-10 of its max |grad|, the update (-lr x the new momentum) within
  1e-10 of its max |update|, and the new params within 1e-10 of their max
  |param|. Not f32: a ReLU net's gradient jumps where a pre-activation
  crosses 0, and in f32 the two sides' last bits put a unit on either side
  now and then (tests/test_torch_train.py); in float64 the sums' orders
  leave ~1e-15.
"""

import numpy as np
import pytest
import torch

from amos_slam_tpu_torch.models import data, train
from amos_slam_tpu_torch.models.yolact import Yolact, make_priors
from benchmark.reference import yolact_train as R
from benchmark.weights import yolact_params

C, LAYERS, B = 81, (1, 1, 1, 1), 2
H = R.Hyper()
CASES = [(101, "fresh"), (101, "stepped"), (2 ** 31 + 7, "fresh"), (2 ** 31 + 7, "stepped")]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batches(seed: int, size: int, n: int = 2):
    """``n`` batches of B augmented SyntheticShapes samples (f32 GTBatch)."""
    ds = data.SyntheticShapes(n=64, size=size, max_shapes=14, seed=seed)
    rng = np.random.default_rng(seed)
    hp = (size + 3) // 4
    return [data.samples_to_gt_batch(
        [data.augment_sample(ds[int(i)], rng) for i in rng.integers(0, len(ds), B)],
        size, 16, (hp, hp), device="cpu") for _ in range(n)]


def setup(seed: int, size: int, start: str, dtype):
    """(port step, state, the batch to compare on) in ``dtype``; ``stepped``
    starts from the state after one port step on another batch."""
    b0, b1 = [train.GTBatch(b.images.to(dtype), b.boxes.to(dtype), b.labels, b.masks.to(dtype))
              for b in batches(seed, size)]
    params = {k: v.to(dtype) for k, v in yolact_params(seed, C, LAYERS, "cpu",
                                                         torch.float32).items()}
    init, step = train.make_train_step(Yolact(C, LAYERS), torch.from_numpy(make_priors(size)),
                                       H.lr, H.momentum, H.weight_decay)
    state = init(params)
    if start == "stepped":
        state = step(state, b0)[0]
    return step, state, b1


def reference(state, batch):
    return R.step(state.params, state.opt_state, batch.images, batch.boxes, batch.labels,
                  batch.masks, LAYERS, H)


@pytest.mark.parametrize("seed,start", CASES)
def test_loss_and_parts_f32(seed, start):
    step, state, batch = setup(seed, 128, start, torch.float32)
    _, loss, aux = step(state, batch)
    ref = reference(state, batch)
    got = {"loss": loss, **aux}
    want = {"loss": ref["loss"], **ref["parts"]}
    for k, v in want.items():
        assert abs(float(got[k]) - float(v)) <= 1e-5 * abs(float(v)), (k, got[k], v)
    assert float(ref["parts"]["mask"]) > 0 and float(ref["parts"]["loc"]) > 0


@pytest.mark.parametrize("seed,start", CASES)
def test_grads_and_step_float64(seed, start):
    _, state, batch = setup(seed, 64, start, torch.float64)
    _, _, grads = train.value_and_grads(Yolact(C, LAYERS), torch.from_numpy(make_priors(64)),
                                        state.params, batch)
    new = train.sgd_update(state, grads, H.lr, H.momentum, H.weight_decay)
    ref = reference(state, batch)
    keys = list(state.params)
    assert list(ref["grads"]) == keys
    for k, g in zip(keys, grads):
        r = ref["grads"][k]
        assert float((g - r).abs().max()) <= 1e-10 * float(r.abs().max()), k
    upd = {k: -H.lr * m for k, m in new.opt_state.items()}
    ref_upd = {k: -H.lr * m for k, m in ref["momentum"].items()}
    gap, worst = R.update_gap(upd, ref_upd)
    assert gap <= 1e-10, (gap, worst)
    for k, p in new.params.items():
        r = ref["params"][k]
        assert float((p - r).abs().max()) <= 1e-10 * float(r.abs().max()), k
