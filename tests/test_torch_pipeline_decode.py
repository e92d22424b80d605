"""The pipelined serving loop and ``--decode-device`` of the port against
the JAX package's (``tests/test_pipeline_decode.py``'s cases).

The deferred decode equals the eager one bit for bit, the pipelined
Predictor loop the strict one, and the port's poses JAX's under the pose
gate (counts and visibility equal, xy within 1e-3 px, confidences within
2e-3). On the CPU there is no side stream: the deferred decode runs in
``materialize()``; the card's side stream is held by the GPU tests and
``chip_smoke.py`` phase 21.
"""

import argparse
import logging
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import field_fixtures  # noqa: E402
import openpifpaf_tpu  # noqa: E402
from openpifpaf_tpu import decoder as jax_decoder  # noqa: E402
from openpifpaf_tpu.models.heads import CompositeField4  # noqa: E402
from openpifpaf_tpu.models.shell import Shell  # noqa: E402
from openpifpaf_tpu_torch import decoder  # noqa: E402
from openpifpaf_tpu_torch.decoder.cifcaf import CifCaf  # noqa: E402
from openpifpaf_tpu_torch.decoder.multi import Multi  # noqa: E402
from openpifpaf_tpu_torch.models import basenetworks, convert_jax  # noqa: E402
from openpifpaf_tpu_torch.models.factory import Factory  # noqa: E402
from openpifpaf_tpu_torch.plugins.coco.constants import \
    cocokp_head_metas  # noqa: E402
from openpifpaf_tpu_torch.predictor import Predictor  # noqa: E402

from torch_port_helpers import NARROW, assert_pose_gate, jax_f32, \
    jax_metas, one_torch_thread, port_metas, pose_rows, posed_head, \
    restored_statics  # noqa: E402

STRIDE = 8
#: lowered thresholds and budgets, as the drawing tests serve posed heads
FLAGS = ('--seed-threshold', '0.05', '--keypoint-threshold', '0.05',
         '--instance-threshold', '0.001', '--decoder-poses', '16',
         '--decoder-crowd-poses', '16')
IMAGE_HW = (65, 97)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    one_torch_thread()


@pytest.fixture(autouse=True)
def _restored_state():
    with restored_statics(*jax_decoder.factory.DECODERS, *decoder.DECODERS):
        yield


def _scene(seed):
    """Two synthetic people's CIF and CAF fields (JAX's encoders)."""
    rng = np.random.RandomState(seed)
    anns = [field_fixtures.annotation_dict(
        field_fixtures.synthetic_person(60 + 70 * i, 90, 100.0, rng))
        for i in range(2)]
    cif, caf, _ = field_fixtures.fields_from_annotations(anns, (169, 217),
                                                         stride=STRIDE)
    return cif, caf


def _key(anns):
    return [(a.score, a.data.tobytes(), a.joint_scales.tobytes())
            for a in anns]


def _configured(flags=()):
    """Both packages' decoder statics set from ``flags``."""
    for factory in (jax_decoder.factory, decoder):
        parser = argparse.ArgumentParser()
        factory.cli(parser)
        factory.configure(parser.parse_args(list(flags)))


def test_deferred_matches_eager_and_jax():
    cif, caf = _scene(1)
    cifcaf = CifCaf(*port_metas(STRIDE))
    fields = [torch.from_numpy(cif[None]), torch.from_numpy(caf[None])]
    eager = cifcaf.batch_decode(fields)[0]
    # two in-flight dispatches before either materialises
    first = cifcaf.batch_decode_deferred(fields)
    second = cifcaf.batch_decode_deferred(
        [torch.from_numpy(cif[None]), torch.from_numpy(caf[None])])
    assert _key(second()[0]) == _key(eager)
    assert _key(first()[0]) == _key(eager)
    assert len(eager) == 2

    metas = jax_metas(STRIDE)
    with jax_f32():
        ref = jax_decoder.CifCaf(*metas).batch_decode_deferred(
            [cif[None], caf[None]])()[0]
    assert_pose_gate(pose_rows(eager), pose_rows(ref))


@pytest.fixture(scope='module')
def models():
    """(JAX shell, its variables, the port's model): one narrow
    ShuffleNetV2K whose cocokp heads decode to whole people."""
    metas = openpifpaf_tpu.datasets.factory('cocokp').head_metas
    base = openpifpaf_tpu.models.basenetworks.ShuffleNetV2K(
        stages_repeats=NARROW[0], stages_out_channels=NARROW[1])
    openpifpaf_tpu.models.shell.assign_strides(metas, base.stride)
    model = Shell(base_net=base, head_nets=tuple(
        CompositeField4(meta=m) for m in metas))
    variables = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 65, 65, 3)), train=True))
    for i, meta in enumerate(metas):
        conv = variables['params'][f'head_nets_{i}']['Conv_0']
        conv['kernel'], conv['bias'] = posed_head(conv['kernel'],
                                                  conv['bias'], meta)
    port_model = Factory().from_scratch(
        cocokp_head_metas(), base_net=basenetworks.ShuffleNetV2K(*NARROW))
    port_model.load_state_dict(convert_jax.state_dict_from_jax(variables),
                               strict=True)
    return model, variables, port_model


def _images(n, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, IMAGE_HW + (3,), dtype=np.uint8)
            for _ in range(n)]


def _served(predictor, images):
    return [(pose_rows(pred), meta['dataset_index'])
            for pred, _, meta in predictor.numpy_images(images)]


@pytest.mark.parametrize('batch_size', [1, 2])
def test_pipelined_predictor_loop_equals_strict(models, batch_size):
    _configured(FLAGS)
    predictor = Predictor(model=models[2], device='cpu')
    predictor.batch_size = batch_size
    images = _images(3)
    predictor.pipeline_decode = False
    strict = _served(predictor, images)
    strict_images = predictor.total_images
    predictor.pipeline_decode = True
    piped = _served(predictor, images)
    assert [i for _, i in piped] == list(range(3))
    assert sum(len(p) for p, _ in strict) > 0
    for (ours, i), (ref, j) in zip(piped, strict):
        assert i == j
        np.testing.assert_array_equal(ours, ref)
    assert predictor.total_images == 2 * strict_images == 6


def test_pipelined_predictor_poses_equal_jax(models):
    model, variables, port_model = models
    _configured(FLAGS)
    images = _images(2, seed=4)
    port = Predictor(model=port_model, device='cpu')
    assert port.pipeline_decode
    ours = _served(port, images)
    jax_predictor = openpifpaf_tpu.Predictor(model=model,
                                             variables=variables)
    assert jax_predictor.pipeline_decode
    with jax_f32():
        ref = _served(jax_predictor, images)
    assert sum(len(p) for p, _ in ours) > 0
    for (o, i), (r, j) in zip(ours, ref):
        assert i == j
        assert_pose_gate(o, r)


def test_decode_device_parse_and_warn_once(caplog):
    """``--decode-device`` sets ``CifCaf.decode_device`` as JAX's does;
    out of range (no card here) the decode stays on the fields' device
    with one warning, however many batches, and the same poses."""
    _configured(('--decode-device', '1'))
    assert CifCaf.decode_device == jax_decoder.CifCaf.decode_device == 1
    cif, caf = _scene(2)
    fields = [torch.from_numpy(cif[None]), torch.from_numpy(caf[None])]
    cifcaf = CifCaf(*port_metas(STRIDE))
    with caplog.at_level(logging.WARNING,
                         logger='openpifpaf_tpu_torch.decoder.cifcaf'):
        routed = [cifcaf.batch_decode(fields)[0] for _ in range(3)]
    warnings = [r for r in caplog.records if 'decode_device=1' in r.message]
    assert len(warnings) == 1
    CifCaf.decode_device = None
    in_place = cifcaf.batch_decode(fields)[0]
    assert len(in_place) == 2
    assert all(_key(r) == _key(in_place) for r in routed)


def test_pipeline_propagates_producer_exceptions():
    predictor = Predictor.__new__(Predictor)  # no model needed
    predictor.pipeline_decode = True

    def batches():
        raise RuntimeError('producer boom')
        yield  # pragma: no cover

    with pytest.raises(RuntimeError, match='producer boom'):
        list(Predictor._run_batches(predictor, batches()))


def test_pipeline_flushes_pending_batch_on_late_failure():
    """A failure while taking or dispatching batch i+1 keeps batch i's
    results: they are yielded before the exception."""
    predictor = Predictor.__new__(Predictor)
    predictor.pipeline_decode = True
    predictor._dispatch_batch = lambda batch: ('staged', batch)
    predictor._materialize_batch = lambda staged: iter([staged[1]])

    def batches():
        yield 'batch0'
        raise RuntimeError('late producer boom')

    got = []
    with pytest.raises(RuntimeError, match='late producer boom'):
        for item in Predictor._run_batches(predictor, batches()):
            got.append(item)
    assert got == ['batch0']

    def dispatch(batch):
        if batch == 'batch1':
            raise RuntimeError('dispatch boom')
        return ('staged', batch)

    predictor._dispatch_batch = dispatch
    got = []
    with pytest.raises(RuntimeError, match='dispatch boom'):
        for item in Predictor._run_batches(predictor,
                                           iter(['batch0', 'batch1'])):
            got.append(item)
    assert got == ['batch0']


def test_deferred_path_honors_instance_batch_decode_override():
    """``--profile-decoder`` wraps a decoder's ``batch_decode`` on the
    instance; the deferred path goes through such an override."""
    class FakeDecoder:
        last_decoder_time = 0.0

        def batch_decode(self, fields_batch):
            return [['eager']]

        def batch_decode_deferred(self, fields_batch):
            return lambda: [['deferred']]

    d = FakeDecoder()
    assert Multi([d]).batch_decode_deferred(None)() == [['deferred']]

    calls = []

    def wrapped(fields_batch):  # stands in for the Profiler wrapper
        calls.append(1)
        return [['profiled']]

    d.batch_decode = wrapped
    assert Multi([d]).batch_decode_deferred(None)() == [['profiled']]
    assert calls == [1]


class _Named:
    """An annotation that only carries a name."""

    def __init__(self, name):
        self.name = name

    def inverse_transform(self, meta):
        return self


class _TimedDecoder:
    """Decodes a batch to its own name, taking ``times[name]`` seconds;
    ``deferred`` gives it the deferred API."""

    def __init__(self, times, deferred):
        self.times = times
        self.last_decoder_time = 0.0
        if deferred:
            self.batch_decode_deferred = self._deferred

    def batch_decode(self, fields_batch):
        self.last_decoder_time = self.times[fields_batch]
        return [[_Named(fields_batch)]]

    def _deferred(self, fields_batch):
        def materialize():
            self.last_decoder_time = self.times[fields_batch]
            return [[_Named(fields_batch)]]
        return materialize


@pytest.mark.parametrize('processor', ['eager', 'multi'])
def test_decoder_time_recorded_at_dispatch(processor):
    """A decode that runs at dispatch keeps its own time, though the next
    batch is dispatched before it is materialised (JAX reads it late,
    ``openpifpaf_tpu/predictor.py:566``)."""
    times = {'a': 1.0, 'b': 2.0, 'c': 4.0}
    eager = _TimedDecoder(times, deferred=False)
    predictor = Predictor.__new__(Predictor)
    predictor.pipeline_decode = True
    predictor.json_data = False
    predictor.total_nn_time = predictor.total_decoder_time = 0.0
    predictor.total_images = 0
    predictor.processor = eager if processor == 'eager' else Multi(
        [eager, _TimedDecoder({k: 10 * v for k, v in times.items()},
                              deferred=True)])
    predictor.fields_batch = lambda name: name
    predictor._nn_seconds = lambda: (lambda: 0.5)
    seen = []
    for pred, _, meta in predictor._run_batches(
            (name, [[]], [{}]) for name in 'abc'):
        seen.append((pred, predictor.last_decoder_time))
    scale = 1.0 if processor == 'eager' else 11.0
    assert [t for _, t in seen] == [scale * times[n] for n in 'abc']
    assert [p[0].name for p, _ in seen] == ['a', 'b', 'c']
    assert predictor.total_decoder_time == scale * 7.0
    assert predictor.total_nn_time == 1.5


@pytest.mark.parametrize('pipelined', [True, False],
                         ids=['pipelined', 'strict'])
def test_reset_marker_is_a_barrier(pipelined):
    """A ``LoaderWithReset.RESET`` marker emits ``eval_reset`` after the
    batch before it was decoded and yielded, in either loop (the
    pipelined loop materialises its pending batch first)."""
    from openpifpaf_tpu_torch.datasets.loader_with_reset import \
        LoaderWithReset
    from openpifpaf_tpu_torch.signal_ import Signal

    predictor = Predictor.__new__(Predictor)
    predictor.pipeline_decode = pipelined
    events = []
    predictor._run_batch = lambda batch: iter([batch])
    predictor._dispatch_batch = lambda batch: events.append(
        ('dispatch', batch)) or batch
    predictor._materialize_batch = lambda staged: iter([staged])
    saved = dict(Signal.subscribers)
    Signal.subscribers = {'eval_reset': [lambda: events.append('reset')]}
    try:
        for batch in predictor._run_batches(
                ['a0', 'a1', LoaderWithReset.RESET, 'b0']):
            events.append(batch)
    finally:
        Signal.subscribers = saved
    yielded = [e for e in events if e == 'reset' or isinstance(e, str)]
    assert yielded == ['a0', 'a1', 'reset', 'b0']
    if pipelined:
        # a1 is dispatched before a0 is yielded
        assert events.index(('dispatch', 'a1')) < events.index('a0')
