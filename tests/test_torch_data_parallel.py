"""The port's data-parallel YOLACT step (parallel/data_parallel.py) on
the CPU: a real 2-rank ``gloo`` group, spawned, against the port's
single-process step and the JAX package's sharded step.

``yolact_tiny``'s net (a (1, 1, 1, 1) backbone, 4 classes) at 64 px with
Flax's init drawn by the port (seed 0) and every batch norm's four
tensors drawn at random (tests/test_torch_train.py's ``bn`` weights); a
global batch of 4 images per step (tests/test_torch_train.py's
``make_batch``, seeds 10 + step), 2 per rank, 2 steps at lr 2e-3. Rank 1
starts from other params, which ``init`` replaces by rank 0's.

Held:
* float64: each step's loss and parts equal the single-process step on
  the global batch within 1e-10 relative, and the params and momentum
  after 2 steps within 1e-10 of each tensor's max |change| / max |value|
  (the halves' means averaged: rounding only);
* f32: each step's loss and parts equal JAX's ``make_train_step`` jitted
  with the batch sharded over 2 of the 8 forced CPU devices and the state
  replicated (tests/test_yolact_train.py), within 1e-5 relative
  (tests/test_torch_train.py's f32 tolerance);
* the params and momentum are equal across the ranks after every run;
* unequal local batches raise on both ranks; no process group raises.

The ranks rendezvous through a file under ``tmp_path`` with a group
timeout of 60 s and are joined with a timeout: a stuck rank fails the
test, it does not hang the suite.
"""

import datetime
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from amos_slam_tpu.models import train as J
from amos_slam_tpu.models.port_torch import port_state_dict
from amos_slam_tpu.models.yolact import Yolact as JYolact, make_priors
from amos_slam_tpu_torch.models import train as T
from amos_slam_tpu_torch.models.resnet import FrozenBN
from amos_slam_tpu_torch.models.segmenter import flax_init_
from amos_slam_tpu_torch.models.yolact import Yolact as TYolact
from amos_slam_tpu_torch.parallel.data_parallel import make_data_parallel_step

C, LAYERS, SIZE, LR = 4, (1, 1, 1, 1), 64, 2e-3
WORLD, B, STEPS = 2, 4, 2
F64_TOL, F32_TOL = 1e-10, 1e-5
JOIN_S = 240


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_batch(rng, S=SIZE, B=B, G=3):
    """tests/test_torch_train.py's batch: 2 boxes and a pad per image."""
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


def batches():
    return [make_batch(np.random.default_rng(10 + i)) for i in range(STEPS)]


def torch_batch(arrays, dtype, rows=slice(None)):
    images, boxes, labels, masks = (torch.from_numpy(np.array(a[rows])) for a in arrays)
    return T.GTBatch(images.permute(0, 3, 1, 2).contiguous().to(dtype), boxes.to(dtype), labels,
                     masks.to(dtype))


def tiny_weights():
    """tests/test_torch_train.py's ``bn`` weights, as numpy."""
    model = TYolact(C, LAYERS)
    flax_init_(model, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    for m in model.modules():
        if isinstance(m, FrozenBN):
            n = m.weight.shape[0]
            for buf, (lo, hi) in ((m.weight, (0.5, 1.5)), (m.bias, (-0.5, 0.5)),
                                  (m.running_mean, (-0.5, 0.5)), (m.running_var, (0.5, 2.0))):
                buf.copy_(torch.from_numpy(rng.uniform(lo, hi, n).astype(np.float32)))
    return {k: v.numpy().copy() for k, v in model.state_dict().items()}


def _rank(rank, init_file, weights, out_dir):
    """One rank: 2 data-parallel steps in float64 and in f32 on its half
    of each global batch, then an unequal split; results to ``out_dir``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=WORLD,
                            rank=rank, timeout=datetime.timedelta(seconds=60))
    try:
        out = {}
        priors = torch.from_numpy(make_priors(SIZE))
        half = slice(rank * B // WORLD, (rank + 1) * B // WORLD)
        for dtype in (torch.float64, torch.float32):
            init, step = make_data_parallel_step(TYolact(C, LAYERS), priors, lr=LR)
            state = init({k: torch.from_numpy(v).to(dtype) + rank for k, v in weights.items()})
            steps = []
            for arrays in batches():
                state, loss, aux = step(state, torch_batch(arrays, dtype, half))
                steps.append({"loss": float(loss), **{k: float(v) for k, v in aux.items()}})
            out[str(dtype)] = {"steps": steps, "params": state.params,
                               "momentum": state.opt_state, "step": int(state.step)}
        uneven = slice(0, 1) if rank == 0 else slice(1, 4)
        try:
            step(state, torch_batch(batches()[0], torch.float32, uneven))
            out["uneven"] = None
        except ValueError as e:
            out["uneven"] = str(e)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' results, spawned and joined with a timeout."""
    tmp = tmp_path_factory.mktemp("dp")
    weights = tiny_weights()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, str(tmp / "rendezvous"), weights, str(tmp)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_S)
    stuck = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    assert not stuck, f"ranks {stuck} did not finish within {JOIN_S} s"
    assert [p.exitcode for p in procs] == [0] * WORLD, [p.exitcode for p in procs]
    return weights, [torch.load(tmp / f"rank{r}.pt") for r in range(WORLD)]


def rel(a, b):
    return abs(a - b) / abs(b)


def test_float64_equals_single_process_step(ranks):
    weights, out = ranks
    init, step = T.make_train_step(TYolact(C, LAYERS), torch.from_numpy(make_priors(SIZE)), lr=LR)
    state = init({k: torch.from_numpy(v).double() for k, v in weights.items()})
    p0 = {k: v.clone() for k, v in state.params.items()}
    got = out[0][str(torch.float64)]
    for i, arrays in enumerate(batches()):
        state, loss, aux = step(state, torch_batch(arrays, torch.float64))
        ref = {"loss": float(loss), **{k: float(v) for k, v in aux.items()}}
        for k, v in ref.items():
            assert rel(got["steps"][i][k], v) <= F64_TOL, (i, k, got["steps"][i][k], v)
    assert got["step"] == int(state.step) == STEPS
    for k, p in state.params.items():
        change = float((p - p0[k]).abs().max())
        assert got["params"][k].dtype == torch.float64
        assert float((got["params"][k] - p).abs().max()) <= F64_TOL * change, k
        m = state.opt_state[k]
        assert float((got["momentum"][k] - m).abs().max()) <= F64_TOL * float(m.abs().max()), k


def test_f32_equals_jax_sharded_step(ranks):
    weights, out = ranks
    model = JYolact(num_classes=C, backbone_layers=LAYERS)
    init, step = J.make_train_step(model, jnp.asarray(make_priors(SIZE)), lr=LR)
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("dp",))
    data, repl = NamedSharding(mesh, P("dp")), NamedSharding(mesh, P())
    sharded = jax.jit(step, in_shardings=(repl, data))
    state = jax.device_put(init(port_state_dict(weights, LAYERS)), repl)
    got = out[0][str(torch.float32)]["steps"]
    for i, (images, boxes, labels, masks) in enumerate(batches()):
        batch = jax.device_put(J.GTBatch(jnp.asarray(images), jnp.asarray(boxes),
                                         jnp.asarray(labels), jnp.asarray(masks)), data)
        state, loss, aux = sharded(state, batch)
        assert len(batch.images.sharding.device_set) == WORLD
        ref = {"loss": float(loss), **{k: float(v) for k, v in aux.items()}}
        for k, v in ref.items():
            assert rel(got[i][k], v) <= F32_TOL, (i, k, got[i][k], v)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_state_replicated_across_ranks(ranks, dtype):
    weights, out = ranks
    a, b = (o[str(dtype)] for o in out)
    assert a["steps"] == b["steps"]
    assert set(a["params"]) == set(weights)
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
        assert torch.equal(a["momentum"][k], b["momentum"][k]), k
    # rank 1 started from other params: init broadcast rank 0's
    k = next(iter(weights))
    assert float((a["params"][k].double() - torch.from_numpy(weights[k]).double()).abs().max()) < 1


def test_uneven_split_raises_on_every_rank(ranks):
    _, out = ranks
    for o in out:
        assert o["uneven"] is not None and "not split evenly over 2 ranks" in o["uneven"], o
    assert "holds 1" in out[0]["uneven"] and "holds 3" in out[1]["uneven"]


def test_raises_without_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_data_parallel_step(TYolact(C, LAYERS), torch.from_numpy(make_priors(SIZE)))
