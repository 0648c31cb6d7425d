"""The port's public helpers against the JAX package's, on the CPU:
``geometry.triangulate.projection_matrix`` and ``solvers.robust``'s
``cauchy_weight`` and ``weighted_normal_eq``, in f32 over single and
batched leading axes, inputs from seeded numpy. Held within 1e-6
relative to the largest JAX output (elementwise products and sums of a
few dozen f32 terms; JAX's einsums run at ``Precision.HIGHEST``, the
port's with TF32 off)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amos_slam_tpu.geometry import triangulate as JT
from amos_slam_tpu.solvers import robust as JR
from amos_slam_tpu_torch.geometry import triangulate as TT
from amos_slam_tpu_torch.solvers import robust as TR

RTOL = 1e-6


def close(t, j):
    j = np.asarray(j)
    assert t.dtype == torch.float32 and tuple(t.shape) == j.shape
    err = float(np.abs(t.numpy() - j).max())
    assert err <= RTOL * float(np.abs(j).max()), err


@pytest.mark.parametrize("lead", [(), (5,), (2, 3)], ids=str)
def test_projection_matrix_equals_jax(lead):
    rng = np.random.default_rng(len(lead))
    K = np.tile(np.array([[500.0, 0, 320], [0, 510, 240], [0, 0, 1]], np.float32), lead + (1, 1))
    K[..., :2, :] += rng.normal(0, 5, lead + (2, 3)).astype(np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), lead + (1, 1))
    T[..., :3, :] = rng.normal(0, 1, lead + (3, 4)).astype(np.float32)
    P = TT.projection_matrix(torch.from_numpy(K), torch.from_numpy(T))
    close(P, JT.projection_matrix(jnp.asarray(K), jnp.asarray(T)))
    assert P.shape[-2:] == (3, 4)


def test_projection_matrix_broadcasts_one_K_over_poses():
    rng = np.random.default_rng(7)
    K = np.array([[400.0, 0, 300], [0, 400, 200], [0, 0, 1]], np.float32)
    T = rng.normal(0, 1, (6, 4, 4)).astype(np.float32)
    close(TT.projection_matrix(torch.from_numpy(K), torch.from_numpy(T)),
          JT.projection_matrix(jnp.asarray(K), jnp.asarray(T)))


@pytest.mark.parametrize("shape,delta2", [((50,), 5.991), ((4, 30), 7.815), ((2, 3, 8), 1.0)],
                         ids=str)
def test_cauchy_weight_equals_jax(shape, delta2):
    chi2 = np.random.default_rng(1).exponential(6.0, shape).astype(np.float32)
    chi2.flat[0] = 0.0
    w = TR.cauchy_weight(torch.from_numpy(chi2), delta2)
    close(w, JR.cauchy_weight(jnp.asarray(chi2), delta2))
    assert float(w.flatten()[0]) == 1.0 and bool((w > 0).all() and (w <= 1).all())


@pytest.mark.parametrize("lead,N,D,P", [((), 40, 2, 6), ((3,), 25, 3, 6), ((2, 2), 16, 2, 7)],
                         ids=str)
def test_weighted_normal_eq_equals_jax(lead, N, D, P):
    rng = np.random.default_rng(N)
    J = rng.normal(0, 10, lead + (N, D, P)).astype(np.float32)
    r = rng.normal(0, 2, lead + (N, D)).astype(np.float32)
    w = rng.uniform(0, 1, lead + (N,)).astype(np.float32)
    w[..., ::5] = 0.0                                  # masked blocks add nothing
    H, b = TR.weighted_normal_eq(*(torch.from_numpy(a) for a in (J, r, w)))
    jH, jb = JR.weighted_normal_eq(*(jnp.asarray(a) for a in (J, r, w)))
    close(H, jH)
    close(b, jb)
