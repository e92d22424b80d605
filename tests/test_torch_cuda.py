"""The PyTorch port on a CUDA device: the hand-written CifHr kernel against
its plain version, and the decode against the JAX poses of the golden file.

Every test here needs a GPU (marker ``gpu``) and skips without one. This
file imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch; there, skip ``tests/conftest.py`` (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from openpifpaf_tpu_torch.decoder import CifCaf
from openpifpaf_tpu_torch.models.shell import assign_strides
from openpifpaf_tpu_torch.ops import cifhr, cifhr_cuda
from openpifpaf_tpu_torch.plugins.coco.constants import cocokp_head_metas

from torch_port_helpers import GOLDEN, GOLDEN_STRIDE, assert_pose_gate, \
    random_cells

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda:0')


@pytest.mark.parametrize('shape', [
    # (n_fields, n_cells, hr_h, hr_w): ragged tiles, several rounds of 256
    # cells, and the decode's 641px map
    (3, 37, 65, 81),
    (5, 700, 129, 161),
    (17, 256, 513, 641),
])
def test_cuda_kernel_matches_plain(cuda, shape):
    """The CUDA kernel against its plain version on the card (atol 1e-5:
    the same summation order, no FMA contraction)."""
    n_fields, n_cells, hr_h, hr_w = shape
    cells = random_cells(n_fields, n_cells, hr_h, hr_w, seed=n_cells,
                         device=cuda)
    before = cifhr_cuda.LAUNCHES
    out = cifhr_cuda.accumulate(*cells, hr_h=hr_h, hr_w=hr_w)
    assert cifhr_cuda.LAUNCHES == before + 1
    ref = cifhr.accumulate_dense(*cells, hr_h=hr_h, hr_w=hr_w)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (n_fields, hr_h, hr_w)
    assert float(ref.max()) > 0.01
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               atol=1e-5, rtol=0)


def test_cuda_decode_matches_golden_jax_poses(cuda):
    """``CifCaf`` on CUDA tensors gives the JAX poses of the golden file
    (tie-free gate of ``test_adversarial_parity.py``) and escalates the
    40-person scene to the crowd tier through the kernel."""
    golden = np.load(GOLDEN)
    names = ('sparse', 'crowd')
    fields = [torch.from_numpy(np.stack([golden[f'{n}_{head}']
                                         for n in names])).to(cuda)
              for head in ('cif', 'caf')]
    decoder = CifCaf(*assign_strides(cocokp_head_metas(), GOLDEN_STRIDE))
    before = cifhr_cuda.LAUNCHES
    annotations = decoder.batch_decode(fields)
    assert cifhr_cuda.LAUNCHES > before
    assert decoder.last_escalated == [1]
    for name, anns in zip(names, annotations):
        ours = [np.concatenate([a.data[:, 2:3], a.data[:, :2],
                                a.joint_scales[:, None]], axis=1)
                for a in anns]
        assert_pose_gate(ours, list(golden[f'{name}_poses']))
