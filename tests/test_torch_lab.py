"""The Mosaic lab's kernels in the PyTorch port against the Pallas kernel
bodies of ``tools/mosaic_lab.py``.

The same seeded numpy inputs go through the lab's kernel body, run by
``pl.pallas_call(..., interpret=True)`` as the lab builds the call, and
through the port's wrapper on CPU tensors (which runs the kernel's plain
version). The shapes have channel counts that are not multiples of 128 and
widths that are not multiples of 16: the TPU pads both, the port neither.

Tolerances, as a share of the reference's largest magnitude: float32 1e-5
for the interleave (exact in fact) and the depthwise conv (summation
order), 1e-4 for branch2 (three chained sums in two frameworks); bfloat16
2^-5 for all three, because the lab's depthwise kernel multiplies and sums
in bfloat16 where the port sums in float32 and rounds once, and because a
one-step difference in y1's or z's rounding carries through branch2.
"""

import functools
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from openpifpaf_tpu_torch.lab import kernels, timing
from openpifpaf_tpu_torch.lab import mosaic_lab as port_lab
from openpifpaf_tpu_torch.models import shuffle_cuda

from torch_port_helpers import jax_f32, lab_arrays, one_torch_thread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_lab():
    """``tools/mosaic_lab.py`` as a module (it puts the repo root on
    ``sys.path`` for its ``import bench``)."""
    spec = importlib.util.spec_from_file_location(
        'mosaic_lab', os.path.join(REPO, 'tools', 'mosaic_lab.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


lab = _load_lab()

#: (h, w, c): C and W off the TPU's 128 and 16
SHAPES = [(9, 11, 8), (13, 7, 24)]
DTYPES = {'float32': (jnp.float32, torch.float32),
          'bfloat16': (jnp.bfloat16, torch.bfloat16)}
#: max abs error / max |reference|
F32_RTOL = {'interleave': 1e-5, 'dw': 1e-5, 'branch2': 1e-4}
BF16_RTOL = 2.0 ** -5


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    one_torch_thread()


@pytest.fixture(autouse=True)
def _f32_matmuls():
    with jax_f32():
        yield


def _hwc(t):
    """(1, C, H, W) -> (H, W, C) float32 numpy."""
    return t[0].permute(1, 2, 0).float().numpy()


def _check(op, dtype_name, out, ref):
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    scale = float(np.abs(ref).max())
    assert scale > 0.1
    rtol = F32_RTOL[op] if dtype_name == 'float32' else BF16_RTOL
    err = float(np.abs(out - ref).max())
    assert err <= rtol * scale, (err, rtol * scale)


def _vmem_call(kernel, out_shape, dtype):
    """A one-block call over whole VMEM arrays, as the lab builds its
    interleave and dw calls (``tools/mosaic_lab.py:64``, ``:98``)."""
    return pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(out_shape, dtype),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True)


@pytest.mark.parametrize('dtype_name', sorted(DTYPES))
@pytest.mark.parametrize('shape', SHAPES)
def test_interleave_matches_lab_kernel(shape, dtype_name):
    h, w, c = shape
    jdt, tdt = DTYPES[dtype_name]
    arrays = lab_arrays('lab_interleave', h, w, c, seed=c)
    ref = _vmem_call(lab.interleave_kernel, (h, w, 2 * c), jdt)(
        *[jnp.asarray(arrays[n], jdt) for n in ('a', 'b')])
    t = kernels.from_lab_arrays(tdt, **arrays)
    out = kernels.lane_interleave(t['a'], t['b'])
    assert out.dtype == tdt
    assert out.is_contiguous(memory_format=torch.channels_last)
    _check('interleave', dtype_name, _hwc(out), ref.astype(jnp.float32))


@pytest.mark.parametrize('dtype_name', sorted(DTYPES))
@pytest.mark.parametrize('shape', SHAPES)
def test_dw_matches_lab_kernel(shape, dtype_name):
    h, w, c = shape
    k = 5
    jdt, tdt = DTYPES[dtype_name]
    arrays = lab_arrays('lab_dw_valid', h, w, c, k=k, seed=h)
    ref = _vmem_call(functools.partial(lab.dw_kernel, k=k, r=h, w=w),
                     (h, w, c), jdt)(
        *[jnp.asarray(arrays[n], jdt) for n in ('x', 'wt')])
    t = kernels.from_lab_arrays(tdt, **arrays)
    out = kernels.dw_valid(t['x'], t['wt'])
    assert out.dtype == tdt and out.shape == (1, c, h, w)
    _check('dw', dtype_name, _hwc(out), ref.astype(jnp.float32))


@pytest.mark.parametrize('dtype_name', sorted(DTYPES))
@pytest.mark.parametrize('shape', SHAPES)
def test_branch2_matches_lab_kernel(monkeypatch, shape, dtype_name):
    """The lab's own ``build_branch2`` (grid of row tiles, the manual halo
    DMA into a VMEM scratch), its ``pallas_call`` in interpret mode."""
    h, w, c = shape
    k, r_tile = 5, 4
    pad = k // 2
    jdt, tdt = DTYPES[dtype_name]
    arrays = lab_arrays('lab_branch2', h, w, c, k=k, seed=w)
    monkeypatch.setattr(pl, 'pallas_call',
                        functools.partial(pl.pallas_call, interpret=True))
    call, n_tiles, wi, _ = lab.build_branch2(h, w, c, k, r_tile, jdt)
    x2 = np.zeros((n_tiles * r_tile + 2 * pad, wi, c), np.float32)
    x2[:h + 2 * pad, :w + 2 * pad] = arrays['x2']
    ref = call(jnp.asarray(x2, jdt),
               *[jnp.asarray(arrays[n], jnp.float32 if n in
                             kernels.LAB_FLOAT32 else jdt)
                 for n in ('w1', 'b1', 'wd', 'bd', 'w3', 'b3')])
    ref = np.asarray(ref.astype(jnp.float32))[:h, :w]

    t = kernels.from_lab_arrays(tdt, **arrays)
    x2_port = t.pop('x2')
    out = kernels.branch2(x2_port, kernels.Branch2Weights(**t))
    assert out.dtype == tdt and out.shape == (1, c, h, w)
    assert out.is_contiguous(memory_format=torch.channels_last)
    _check('branch2', dtype_name, _hwc(out), ref)


def test_from_lab_arrays_layouts_and_types():
    rng = np.random.RandomState(0)
    x2, wd = rng.randn(6, 7, 3), rng.randn(5, 5, 3)
    t = kernels.from_lab_arrays(
        torch.bfloat16, x2=x2, w1=rng.randn(3, 3), wd=wd,
        wt=rng.randn(5, 5, 3), b1=rng.randn(3))
    assert t['x2'].shape == (1, 3, 6, 7)
    assert t['x2'].is_contiguous(memory_format=torch.channels_last)
    assert t['wd'].shape == t['wt'].shape == (3, 1, 5, 5)
    assert [t[n].dtype for n in ('x2', 'w1', 'wt', 'wd', 'b1')] == [
        torch.bfloat16] * 3 + [torch.float32] * 2
    np.testing.assert_array_equal(t['wd'][:, 0].numpy(),
                                  wd.transpose(2, 0, 1).astype(np.float32))
    np.testing.assert_array_equal(
        _hwc(t['x2']), torch.from_numpy(x2).bfloat16().float().numpy())


@pytest.mark.parametrize('call', [
    lambda x: kernels.lane_interleave(x, x),
    lambda x: kernels.dw_valid(x, torch.zeros(4, 1, 5, 5, device='meta')),
    lambda x: kernels.branch2(x, None),
], ids=['interleave', 'dw_valid', 'branch2'])
def test_wrappers_raise_off_cpu_and_cuda(call):
    """A tensor on neither the CPU nor a CUDA device is refused before any
    launch; nothing falls back to the plain version."""
    x = torch.zeros(1, 4, 9, 9, device='meta').contiguous(
        memory_format=torch.channels_last)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match='CPU or CUDA'):
        call(x)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('stage', sorted(port_lab.STAGES))
def test_branch2_plans_by_tile_rows(stage, dtype):
    """The lab's branch2 is the fused-block kernel's lab mode: at each lab
    stage a plan fits tile heights 4 and 8 of the sweep (a depthwise strip
    holds at most 8 rows), the default plan fits a CTA's 227 KB, and the
    plans cover the channels."""
    h, w, c = port_lab.STAGES[stage]
    fits = []
    for rt in (4,) + port_lab.RTILES:
        try:
            p = kernels.branch2_plan(1, h, w, c, dtype=dtype, r_tile=rt)
        except ValueError as e:
            assert 'no plan fits' in str(e)
            continue
        assert p.th == rt and p.cb_pad - p.slice < c <= p.cb_pad
        fits.append(rt)
    assert tuple(fits) == (4, 8)
    p = kernels.branch2_plan(1, h, w, c, dtype=dtype)
    assert p.smem <= shuffle_cuda.SMEM_LIMIT
    assert p.slice % 16 == 0 and p.cb_pad - p.slice < c <= p.cb_pad
    assert p.ctas == -(-h // p.th) * -(-w // p.tw) * p.cluster


def test_entry_point_refuses_the_cpu():
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES='')
    done = subprocess.run(
        [sys.executable, '-m', 'openpifpaf_tpu_torch.lab.mosaic_lab',
         'interleave'], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300, check=False)
    assert done.returncode != 0
    assert 'needs a CUDA device' in done.stderr
    assert done.stdout == ''


def test_entry_point_rejects_unknown_names():
    with pytest.raises(SystemExit, match='unknown lab names'):
        port_lab.main(['interleave', 'block'])


def test_time_op_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip('checks the refusal without a CUDA device')
    with pytest.raises(RuntimeError, match='CUDA device'):
        timing.time_op(lambda: None)
