"""The tracking golden file (``golden/torch_tracking_golden.npz``, the
synthetic 6-frame video of ``torch_port_helpers.tracking_scene`` with the
JAX package's annotations and track ids of each frame) against a fresh
JAX decode, and the port's decode of it on the CPU. ``chip_smoke.py``
phase 13b and ``test_torch_cuda.py`` hold the port to it on the card,
where JAX is absent."""

import numpy as np
import pytest
import torch

import torch_port_helpers as helpers


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    helpers.one_torch_thread()


@pytest.fixture(scope='module')
def golden():
    return np.load(helpers.TRACKING_GOLDEN)


def test_tracking_golden_matches_fresh_jax_decode(golden):
    fresh = helpers.jax_tracking_golden()
    assert set(fresh) == set(golden.files)
    for name, value in fresh.items():
        if name.endswith(('_poses',)):
            np.testing.assert_allclose(golden[name], value, atol=1e-5,
                                       rtol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(golden[name], value,
                                          err_msg=name)
    frames = helpers.tracking_golden_fields(golden)
    for stored, made in zip(frames, helpers.tracking_scene()):
        for a, b in zip(stored, made):
            np.testing.assert_array_equal(a, b)
    ids = [golden[f'frame{t}_ids'] for t in range(len(frames))]
    assert [len(i) for i in ids] == [6] * 6
    # tracked ids that persist, and new ones
    assert any(set(a[a > 0]) & set(b[b > 0]) for a, b in zip(ids, ids[1:]))
    assert len({int(i) for a in ids for i in a if i > 0}) > 3


def test_port_decodes_the_tracking_golden_file(golden):
    helpers.reset_track_ids()
    multi = helpers.port_tracking_decoder(helpers.GOLDEN_STRIDE)
    frames = helpers.tracking_golden_fields(golden)
    for t, anns in enumerate(helpers.decode_frames(multi, frames,
                                                   torch.from_numpy)):
        helpers.assert_tracking_frame(anns, golden[f'frame{t}_poses'],
                                      golden[f'frame{t}_ids'],
                                      label=f'frame {t}')
