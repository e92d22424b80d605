"""CifHr of the PyTorch port against the JAX package.

``select_cells``, the plain ``accumulate_dense`` and ``cifhr_lookup`` of
``openpifpaf_tpu_torch/ops/cifhr.py`` are held against JAX's
``accumulate_dense`` and against the Pallas kernel in interpret mode at
``k_tile = K`` (the crowd-tier contract: no per-tile budget), on the
``random_cells`` of ``test_cifhr_pallas.py``. Tolerance: atol 1e-6, the
Pallas tests' own: the port runs the same float operations in the same
order, and XLA's fusions differ from it only in the last bits.

The CUDA kernel itself only runs on a GPU (``chip_smoke.py`` and
``test_torch_cuda.py``); here the wrapper must take the plain path for CPU
tensors.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openpifpaf_tpu.ops import cifhr as jax_cifhr
from openpifpaf_tpu.ops.cifhr_pallas import accumulate_pallas
from openpifpaf_tpu_torch.ops import cifhr, cifhr_cuda

from test_cifhr_pallas import random_cells
from torch_port_helpers import jax_f32, one_torch_thread

ATOL = 1e-6


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    one_torch_thread()


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _random_cif(n_fields, h, w, seed):
    rng = np.random.RandomState(seed)
    cif = np.zeros((n_fields, 5, h, w), np.float32)
    cif[:, 1] = rng.uniform(0.0, 1.0, (n_fields, h, w))
    cif[:, 2] = rng.uniform(-1.0, w, (n_fields, h, w))
    cif[:, 3] = rng.uniform(-1.0, h, (n_fields, h, w))
    cif[:, 4] = rng.uniform(0.0, 3.0, (n_fields, h, w))
    return cif


@pytest.mark.parametrize('n_cells', [16, 256])
def test_select_cells_matches_jax(n_cells):
    """Top-K selection with JAX's tie order, the payload gather (a one-hot
    matmul in JAX, ``torch.gather`` here) and the overflow flag."""
    cif = _random_cif(17, 9, 11, seed=n_cells)
    cif[:, 1, :2, :2] = 0.75  # ties: the lower index must come first
    kw = dict(threshold=0.3, min_scale=0.0, n_cells=n_cells)
    with jax_f32():
        ref = jax_cifhr.select_cells(jnp.asarray(cif), 8, **kw)
    out = cifhr.select_cells(torch.from_numpy(cif), 8, **kw)
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL,
                                   rtol=0)
    assert bool(out[-1]) == bool(ref[-1]) == (n_cells == 16)


@pytest.mark.parametrize('case', [
    # (n_fields, n_cells, hr_h, hr_w, seed, dead_fraction, kwargs)
    (5, 37, 65, 81, 3, 0.4, {}),
    (17, 96, 97, 129, 1, 0.4, {}),
    (3, 32, 65, 81, 5, 0.4, {'neighbors': 8, 'factor': 0.5}),
])
def test_accumulate_matches_jax_dense_and_pallas(case):
    n_fields, n_cells, hr_h, hr_w, seed, dead, kwargs = case
    cells = random_cells(n_fields, n_cells, hr_h, hr_w, seed=seed,
                         dead_fraction=dead)
    with jax_f32():
        dense = np.asarray(jax_cifhr.accumulate_dense(
            *cells, hr_h=hr_h, hr_w=hr_w, **kwargs))
        pallas = np.asarray(accumulate_pallas(
            *cells, hr_h=hr_h, hr_w=hr_w, interpret=True, k_tile=n_cells,
            **kwargs))
    out = cifhr.accumulate_dense(*_torch(*cells), hr_h=hr_h, hr_w=hr_w,
                                 **kwargs).numpy()
    assert dense.max() > 0.01
    np.testing.assert_allclose(out, dense, atol=ATOL, rtol=0)
    np.testing.assert_allclose(out, pallas, atol=ATOL, rtol=0)


def test_accumulate_clamps_at_one():
    """Overlapping high-weight splats saturate at min(sum, 1)."""
    n = 48
    x = np.full((1, n), 40.0, np.float32)
    y = np.full((1, n), 32.0, np.float32)
    sigma = np.full((1, n), 12.0, np.float32)
    w = np.ones((1, n), np.float32)
    with jax_f32():
        ref = np.asarray(jax_cifhr.accumulate_dense(
            *(jnp.asarray(a) for a in (x, y, sigma, w)), hr_h=65, hr_w=81,
            neighbors=1))
    out = cifhr.accumulate_dense(*_torch(x, y, sigma, w), hr_h=65, hr_w=81,
                                 neighbors=1).numpy()
    assert out.max() == 1.0
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_cif_hr_and_lookup_match_jax():
    """The whole materialised map from a CIF field and its point lookups
    with the reference rounding and bounds."""
    cif = _random_cif(17, 9, 11, seed=4)
    with jax_f32():
        hr_ref, over_ref = jax_cifhr.cif_hr(jnp.asarray(cif), 8,
                                            impl='dense', n_cells=32,
                                            return_overflow=True)
    hr, over = cifhr.cif_hr(torch.from_numpy(cif), 8, n_cells=32,
                            return_overflow=True)
    np.testing.assert_allclose(hr.numpy(), np.asarray(hr_ref), atol=ATOL,
                               rtol=0)
    assert bool(over) == bool(over_ref)

    rng = np.random.RandomState(0)
    f = rng.randint(0, 17, 200)
    x = rng.uniform(-2.0, hr.shape[2] + 1.0, 200).astype(np.float32)
    y = rng.uniform(-2.0, hr.shape[1] + 1.0, 200).astype(np.float32)
    ref = np.asarray(jax_cifhr.cifhr_lookup(hr_ref, f, x, y))
    out = cifhr.cifhr_lookup(*_torch(hr_ref, f, x, y)).numpy()
    np.testing.assert_array_equal(out, ref)


def test_wrapper_takes_plain_path_on_cpu():
    """A CPU tensor goes to the plain version, launches nothing."""
    cells = _torch(*random_cells(5, 37, 65, 81, seed=3))
    before = cifhr_cuda.LAUNCHES
    out = cifhr_cuda.accumulate(*cells, hr_h=65, hr_w=81)
    assert cifhr_cuda.LAUNCHES == before
    np.testing.assert_array_equal(
        out.numpy(), cifhr.accumulate_dense(*cells, hr_h=65, hr_w=81).numpy())


def test_wrapper_rejects_other_devices():
    cells = [torch.zeros((2, 4), device='meta') for _ in range(4)]
    with pytest.raises(ValueError, match='CUDA'):
        cifhr_cuda.accumulate(*cells, hr_h=9, hr_w=9)

