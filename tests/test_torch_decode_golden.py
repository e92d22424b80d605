"""The golden file's decoder-configuration entries against fresh JAX
decodes, one (scene, configuration) pair per test: the poses, decoding
orders and ids that ``chip_smoke.py`` phase 5b and the GPU tests hold the
port to on the card, where JAX is absent
(``torch_port_helpers.golden_runs``). The fields and the default decodes
are held by ``test_torch_decode.py::
test_golden_file_matches_fresh_jax_decode``."""

import numpy as np
import pytest

import torch_port_helpers as helpers


@pytest.fixture(scope='module')
def golden():
    return np.load(helpers.GOLDEN)


@pytest.fixture(scope='module')
def scenes():
    return helpers.golden_scenes()


@pytest.mark.parametrize('scene,config', helpers.golden_configs(),
                         ids=lambda v: v)
def test_golden_config_matches_fresh_jax_decode(golden, scenes, scene,
                                                config):
    default = golden[f'{scene}_default_poses'] if config == 'tracked' \
        else None
    fresh = helpers.jax_golden_config(scenes, scene, config, default)
    keys = helpers.golden_config_keys(scene, config) & set(golden.files)
    assert keys == set(fresh)
    for name, value in fresh.items():
        np.testing.assert_allclose(golden[name], value, atol=1e-5, rtol=0,
                                   err_msg=name)
    assert len(fresh[f'{scene}_{config}_poses']) == \
        (3 if scene == 'sparse' else 40)
