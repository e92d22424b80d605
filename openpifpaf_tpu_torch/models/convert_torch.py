"""Load reference (PyTorch OpenPifPaf) checkpoints into the port
(counterpart of ``openpifpaf_tpu/models/convert_torch.py``).

The reference pickles the whole ``nn.Module`` tree into its checkpoints:
``{'model': Shell, 'epoch': int, 'meta': {...}}``. Unpickling that
normally needs the reference package; here a restricted unpickler
resolves only what a torch checkpoint needs (:data:`_ALLOWED`: torch's
tensor rebuilds, numpy's arrays; the classes of ``torch.nn`` modules and
the container types of ``builtins``) and stands an inert attribute bag in
for every class of another package (``openpifpaf.*``, ``torchvision.*``),
so the parameter tree can be walked without the original code. Any other
global of the standard library, torch or numpy (``builtins.exec``,
``os.system``, ``functools.partial``, ``torch.hub.load``, ...) raises
``pickle.UnpicklingError`` before it is called. Plain ``state_dict``
checkpoints load too.

The reference's dotted names go through explicit per-architecture maps
into the flax variable tree of the JAX package (the same maps as JAX's
converter), and :func:`convert_jax.state_dict_from_jax` takes that tree to
the port's names, so one naming bridge serves both converters:

  - conv weights: torch OIHW -> HWIO -> OIHW (grouped and depthwise too);
  - BatchNorm: weight/bias and running statistics;
  - CompositeField3 heads: channels reordered into the CompositeField4
    layout (the reference's own "v4 style" inference output).
"""

import dataclasses
import io
import logging
import pickle
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import headmeta
from . import convert_jax

LOG = logging.getLogger(__name__)


# ------------------------------------------------------------------
# restricted unpickling
# ------------------------------------------------------------------

#: the globals of the standard library, torch and numpy that a reference
#: checkpoint names: tensor and parameter rebuilds, containers, the
#: checkpoint's ``args``, the bytes of protocol-2 pickles and the numpy
#: arrays and scalars of its head metas (``pose``)
_ALLOWED = {
    ('collections', 'OrderedDict'),
    ('argparse', 'Namespace'),
    ('copyreg', '_reconstructor'),
    ('_codecs', 'encode'),
    ('torch', 'Size'),
    ('torch', 'device'),
    ('torch._utils', '_rebuild_tensor'),
    ('torch._utils', '_rebuild_tensor_v2'),
    ('torch._utils', '_rebuild_parameter'),
    ('torch._utils', '_rebuild_parameter_with_state'),
    ('numpy', 'ndarray'),
    ('numpy', 'dtype'),
    ('numpy.core.multiarray', '_reconstruct'),
    ('numpy.core.multiarray', 'scalar'),
    ('numpy._core.multiarray', '_reconstruct'),
    ('numpy._core.multiarray', 'scalar'),
}

_BUILTIN_CONTAINERS = {'object', 'dict', 'list', 'tuple', 'set',
                       'frozenset', 'bytes', 'bytearray', 'slice', 'int',
                       'float', 'complex', 'bool', 'str', 'range'}

#: module roots whose globals must be on the allow list; a class of any
#: other root is stubbed
_GUARDED_ROOTS = frozenset(sys.stdlib_module_names) | {'torch', 'numpy'}


class _Stub:
    """Attribute bag standing in for a class of another package."""

    _name = '?'

    def __init__(self, *args, **kwargs):
        self._args = args
        self._kwargs = kwargs

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        elif isinstance(state, tuple) and len(state) == 2:
            if state[0]:
                self.__dict__.update(state[0])
            if state[1]:
                self.__dict__.update(state[1])
        else:
            self.__dict__['_state'] = state

    def __repr__(self):
        return f'<stub {type(self)._name}>'


_STUB_CACHE: Dict[str, type] = {}


def _stub_class(module, name):
    full = f'{module}.{name}'
    if full not in _STUB_CACHE:
        _STUB_CACHE[full] = type(name.rsplit('.', 1)[-1], (_Stub,),
                                 {'_name': full})
    return _STUB_CACHE[full]


def _python3_name(module, name):
    """The Python 3 name of a protocol-2 global (``__builtin__.set``)."""
    import _compat_pickle  # pylint: disable=import-outside-toplevel
    if (module, name) in _compat_pickle.NAME_MAPPING:
        return _compat_pickle.NAME_MAPPING[(module, name)]
    return _compat_pickle.IMPORT_MAPPING.get(module, module), name


class RestrictedUnpickler(pickle.Unpickler):
    """Resolves the allowed globals, stubs the classes of other packages
    and raises ``pickle.UnpicklingError`` for any other global."""

    def find_class(self, module, name):
        module, name = _python3_name(module, name)
        root = module.split('.')[0]
        if root not in _GUARDED_ROOTS:
            return _stub_class(module, name)
        if (module, name) in _ALLOWED or (
                module == 'builtins' and name in _BUILTIN_CONTAINERS):
            return super().find_class(module, name)
        if module == 'torch' and isinstance(getattr(torch, name, None),
                                            torch.dtype):
            return getattr(torch, name)
        if module.startswith('torch.nn.modules.'):
            cls = super().find_class(module, name)
            if isinstance(cls, type) and issubclass(cls, torch.nn.Module):
                return cls
        raise pickle.UnpicklingError(
            f'global {module}.{name} is not allowed in a checkpoint')


def _pickle_module():
    """The ``pickle_module`` for ``torch.load``."""
    mod = type('restricted_pickle', (), {})()
    mod.__name__ = 'restricted_pickle'
    mod.Unpickler = RestrictedUnpickler
    mod.load = lambda f, **kw: RestrictedUnpickler(f, **kw).load()
    mod.loads = lambda b, **kw: RestrictedUnpickler(io.BytesIO(b),
                                                    **kw).load()
    mod.dump = pickle.dump
    mod.dumps = pickle.dumps
    return mod


def load_torch_checkpoint(path):
    """A reference checkpoint -> (flat state dict, epoch, meta dict, model
    stub or None).

    The flat state dict maps dotted torch names (``base_net.stage2.0...``)
    to numpy arrays.
    """
    with open(path, 'rb') as f:
        ckpt = torch.load(f, map_location='cpu', weights_only=False,
                          pickle_module=_pickle_module())

    epoch = 0
    meta = {}
    model = ckpt
    if isinstance(ckpt, dict):
        epoch = int(ckpt.get('epoch', 0))
        raw_meta = ckpt.get('meta', {})
        if isinstance(raw_meta, dict):
            meta = raw_meta
        model = ckpt.get('model', ckpt.get('state_dict', ckpt))

    if isinstance(model, (_Stub, torch.nn.Module)):
        flat = {}
        _walk_module_stub(model, '', flat)
        return flat, epoch, meta, model
    if isinstance(model, dict):
        flat = {k: _to_numpy(v) for k, v in model.items()
                if _is_tensor_like(v)}
        return flat, epoch, meta, None
    raise ValueError(f'unrecognized checkpoint structure in {path}')


def _is_tensor_like(v):
    return isinstance(v, (torch.Tensor, np.ndarray))


def _to_numpy(v):
    if isinstance(v, np.ndarray):
        return v
    return v.detach().cpu().numpy()


def _walk_module_stub(stub, prefix, out):
    d = stub.__dict__
    for k, v in (d.get('_parameters') or {}).items():
        if v is not None and _is_tensor_like(v):
            out[prefix + k] = _to_numpy(v)
    for k, v in (d.get('_buffers') or {}).items():
        if v is not None and _is_tensor_like(v):
            out[prefix + k] = _to_numpy(v)
    for k, v in (d.get('_modules') or {}).items():
        if v is not None:
            _walk_module_stub(v, prefix + k + '.', out)


# ------------------------------------------------------------------
# head metas from a pickled reference model
# ------------------------------------------------------------------

_HEADMETA_BY_REF_NAME = {
    'Cif': headmeta.Cif,
    'Caf': headmeta.Caf,
    'CifDet': headmeta.CifDet,
    'TSingleImageCif': headmeta.TSingleImageCif,
    'TSingleImageCaf': headmeta.TSingleImageCaf,
    'Tcaf': headmeta.Tcaf,
}


def _class_name(obj):
    if isinstance(obj, _Stub):
        return type(obj)._name.rsplit('.', 1)[-1]
    return type(obj).__name__


def _head_nets(model_stub):
    """The pickled model's head modules, in order."""
    if model_stub is None:
        return []
    head_nets = model_stub.__dict__.get('_modules', {}).get('head_nets')
    if head_nets is None:
        return []
    return [hn for _, hn in sorted(
        head_nets.__dict__.get('_modules', {}).items(),
        key=lambda kv: int(kv[0]))]


def head_metas_from_stub(model_stub) -> List[headmeta.Base]:
    """The port's headmeta dataclasses from the pickled reference heads."""
    metas = []
    for hn in _head_nets(model_stub):
        ref_meta = hn.__dict__.get('meta')
        if ref_meta is None:
            continue
        cls_name = _class_name(ref_meta)
        cls = _HEADMETA_BY_REF_NAME.get(cls_name)
        if cls is None:
            LOG.warning('unknown reference head meta %s', cls_name)
            continue
        kwargs = {}
        for f in dataclasses.fields(cls):
            if not f.init:
                continue
            if hasattr(ref_meta, f.name):
                value = getattr(ref_meta, f.name)
                if isinstance(value, torch.Tensor):
                    value = _to_numpy(value)
                kwargs[f.name] = value
        meta = cls(**kwargs)
        meta.upsample_stride = getattr(ref_meta, 'upsample_stride', 1)
        meta.base_stride = getattr(ref_meta, 'base_stride', meta.base_stride)
        meta.head_index = getattr(ref_meta, 'head_index', meta.head_index)
        metas.append(meta)
    return metas


def head_types_from_stub(model_stub) -> List[str]:
    """Head module class names of a pickled reference model
    (``'CompositeField4'``, ``'CompositeField3'``)."""
    return [_class_name(hn) for hn in _head_nets(model_stub)]


# ------------------------------------------------------------------
# name maps: torch dotted names -> flax tree paths
# ------------------------------------------------------------------

def _set(tree, path, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _hwio(w):
    return w.transpose(2, 3, 1, 0)


class _Mapper:
    def __init__(self, flat: Dict[str, np.ndarray], torch_prefix: str = ''):
        self.flat = flat
        self.prefix = torch_prefix
        self.params: dict = {}
        self.batch_stats: dict = {}
        self.used = set()

    def _get(self, name):
        full = self.prefix + name
        if full not in self.flat:
            raise KeyError(f'missing weight {full!r} in torch checkpoint')
        self.used.add(full)
        return self.flat[full]

    def conv(self, t_name: str, f_path: Tuple[str, ...], bias=False):
        _set(self.params, f_path + ('kernel',),
             _hwio(self._get(t_name + '.weight')))
        if bias:
            _set(self.params, f_path + ('bias',), self._get(t_name + '.bias'))

    def bn(self, t_name: str, f_path: Tuple[str, ...]):
        _set(self.params, f_path + ('scale',), self._get(t_name + '.weight'))
        _set(self.params, f_path + ('bias',), self._get(t_name + '.bias'))
        _set(self.batch_stats, f_path + ('mean',),
             self._get(t_name + '.running_mean'))
        _set(self.batch_stats, f_path + ('var',),
             self._get(t_name + '.running_var'))
        self.used.add(self.prefix + t_name + '.num_batches_tracked')

    def cna(self, t_conv: str, t_bn: str, f_module: Tuple[str, ...]):
        """A torch [conv, bn] pair -> a flax ConvNormAct."""
        self.conv(t_conv, f_module + ('Conv_0',))
        self.bn(t_bn, f_module + ('BatchNorm_0',))


def _map_shufflenetv2k(m: _Mapper, stages_repeats, *, input_block=True,
                       input_conv2=False):
    """ShuffleNetV2K and torchvision's ShuffleNetV2 (the same block
    layout; the latter keeps torchvision's ``conv1``)."""
    if input_block:
        m.cna('input_block.0.0', 'input_block.0.1', ('ConvNormAct_0',))
        if input_conv2:
            m.cna('input_block.1.0', 'input_block.1.1', ('ConvNormAct_1',))
    else:
        m.cna('conv1.0', 'conv1.1', ('ConvNormAct_0',))

    block = 0
    for stage_i, repeats in enumerate(stages_repeats):
        t_stage = f'stage{stage_i + 2}'
        for i in range(repeats):
            f_block = (f'InvertedResidualK_{block}',)
            t = f'{t_stage}.{i}'
            pairs = [] if i else [('branch1.0', 'branch1.1'),
                                  ('branch1.2', 'branch1.3')]
            pairs += [('branch2.0', 'branch2.1'), ('branch2.3', 'branch2.4'),
                      ('branch2.5', 'branch2.6')]
            for j, (conv, bn) in enumerate(pairs):
                m.cna(f'{t}.{conv}', f'{t}.{bn}',
                      f_block + (f'ConvNormAct_{j}',))
            block += 1

    conv5_f = 'ConvNormAct_2' if input_conv2 else 'ConvNormAct_1'
    m.cna('conv5.0', 'conv5.1', (conv5_f,))


def _map_resnet(m: _Mapper, layers, *, basic_block=False):
    """torchvision's ResNet/ResNeXt as the reference wraps it
    (``input_block`` and ``block2``-``block5``)."""
    m.conv('input_block.0', ('Conv_0',))
    m.bn('input_block.1', ('BatchNorm_0',))

    block = 0
    for block_i, repeats in enumerate(layers):
        t_block = f'block{block_i + 2}'
        for i in range(repeats):
            t = f'{t_block}.{i}'
            if basic_block:
                f = (f'BasicBlock_{block}',)
                convs = ['1', '2']
                projection = i == 0 and block_i > 0
            else:
                f = (f'Bottleneck_{block}',)
                convs = ['1', '2', '3']
                projection = i == 0
            for j, c in enumerate(convs):
                m.cna(f'{t}.conv{c}', f'{t}.bn{c}', f + (f'ConvNormAct_{j}',))
            if projection:
                m.cna(f'{t}.downsample.0', f'{t}.downsample.1',
                      f + (f'ConvNormAct_{len(convs)}',))
            block += 1


def _map_mobilenetv2(m: _Mapper):
    """torchvision's MobileNetV2 features, the reference's ``backbone``."""
    from .basenetworks import MobileNetV2

    m.cna('backbone.0.0', 'backbone.0.1', ('ConvNormAct_0',))
    block = 0
    t_idx = 1
    for expand, _, repeats, _ in MobileNetV2.config:
        for _ in range(repeats):
            f = (f'InvertedResidualV2_{block}',)
            t = f'backbone.{t_idx}'
            n_cna = 1 if expand == 1 else 2
            for j in range(n_cna):
                m.cna(f'{t}.conv.{j}.0', f'{t}.conv.{j}.1',
                      f + (f'ConvNormAct_{j}',))
            # the projection: a bare conv and its BatchNorm
            m.conv(f'{t}.conv.{n_cna}', f + (f'ConvNormAct_{n_cna}',
                                             'Conv_0'))
            m.bn(f'{t}.conv.{n_cna + 1}', f + (f'ConvNormAct_{n_cna}',
                                               'BatchNorm_0'))
            block += 1
            t_idx += 1
    m.cna(f'backbone.{t_idx}.0', f'backbone.{t_idx}.1', ('ConvNormAct_1',))


def _map_mobilenetv3(m: _Mapper, variant: str):
    """torchvision's MobileNetV3 features, the reference's ``backbone``."""
    from .basenetworks import MobileNetV3

    config = (MobileNetV3.config_large if variant == 'large'
              else MobileNetV3.config_small)
    m.cna('backbone.0.0', 'backbone.0.1', ('ConvNormAct_0',))
    in_features = 16
    for block, (_, hidden, features, use_se, _, _) in enumerate(config):
        f = (f'InvertedResidualV3_{block}',)
        t = f'backbone.{block + 1}.block'
        cna_i = 0
        t_i = 0
        if hidden != in_features:
            m.cna(f'{t}.{t_i}.0', f'{t}.{t_i}.1', f + (f'ConvNormAct_{cna_i}',))
            cna_i += 1
            t_i += 1
        m.cna(f'{t}.{t_i}.0', f'{t}.{t_i}.1', f + (f'ConvNormAct_{cna_i}',))
        cna_i += 1
        t_i += 1
        if use_se:
            se = f + ('SqueezeExcite_0',)
            m.conv(f'{t}.{t_i}.fc1', se + ('Conv_0',), bias=True)
            m.conv(f'{t}.{t_i}.fc2', se + ('Conv_1',), bias=True)
            t_i += 1
        m.cna(f'{t}.{t_i}.0', f'{t}.{t_i}.1', f + (f'ConvNormAct_{cna_i}',))
        in_features = features
    last_t = f'backbone.{len(config) + 1}'
    m.cna(f'{last_t}.0', f'{last_t}.1', ('ConvNormAct_1',))


def _map_squeezenet(m: _Mapper):
    """torchvision's SqueezeNet 1.1 features: biased convs, no norm."""
    m.conv('backbone.0', ('Conv_0',), bias=True)
    fire_t = (3, 4, 6, 7, 9, 10, 11, 12)
    for i, t_idx in enumerate(fire_t):
        f = (f'Fire_{i}',)
        for j, name in enumerate(('squeeze', 'expand1x1', 'expand3x3')):
            m.conv(f'backbone.{t_idx}.{name}', f + (f'Conv_{j}',), bias=True)


_SHUFFLENET_REPEATS = {
    'shufflenetv2k16': [4, 8, 4],
    'shufflenetv2k20': [5, 10, 5],
    'shufflenetv2kx5': [6, 13, 6],
    'shufflenetv2k30': [8, 16, 6],
    'shufflenetv2k44': [12, 24, 8],
    'shufflenetv2x1': [4, 8, 4],
    'shufflenetv2x2': [4, 8, 4],
}

_RESNET_LAYERS = {
    'resnet18': ((2, 2, 2, 2), True),
    'resnet50': ((3, 4, 6, 3), False),
    'resnet101': ((3, 4, 23, 3), False),
    'resnet152': ((3, 8, 36, 3), False),
    'resnext50': ((3, 4, 6, 3), False),
    'resnext101': ((3, 4, 23, 3), False),
}


def convert_base_net(flat: Dict[str, np.ndarray], base_name: str,
                     torch_prefix: str = 'base_net.'):
    """The backbone's weights -> (params, batch_stats, used names)."""
    name = base_name[1:] if base_name.startswith('t') else base_name
    m = _Mapper(flat, torch_prefix)
    if name in _SHUFFLENET_REPEATS:
        _map_shufflenetv2k(
            m, _SHUFFLENET_REPEATS[name],
            input_block=not name.startswith('shufflenetv2x'),
            input_conv2=any(k.startswith(torch_prefix + 'input_block.1.')
                            for k in flat))
    elif name in _RESNET_LAYERS:
        layers, basic = _RESNET_LAYERS[name]
        _map_resnet(m, layers, basic_block=basic)
    elif name == 'mobilenetv2':
        _map_mobilenetv2(m)
    elif name in ('mobilenetv3large', 'mobilenetv3small'):
        _map_mobilenetv3(m, name.replace('mobilenetv3', ''))
    elif name == 'squeezenet':
        _map_squeezenet(m)
    else:
        raise NotImplementedError(
            f'no torch conversion map for backbone {base_name!r}')
    return m.params, m.batch_stats, m.used


def convert_tracking_heads(flat: Dict[str, np.ndarray]):
    """The TBaseSingleImage (``head.conv``) and Tcaf
    (``feature_reduction``, ``feature_compute`` and ``head.conv``) heads
    of a tracking checkpoint."""
    params = {}
    used = set()
    i = 0
    while f'head_nets.{i}.head.conv.weight' in flat:
        t = f'head_nets.{i}'
        head = {}
        if f'{t}.feature_reduction.0.weight' in flat:
            for name in ('feature_reduction', 'feature_compute'):
                head[name] = {'kernel': _hwio(flat[f'{t}.{name}.0.weight']),
                              'bias': flat[f'{t}.{name}.0.bias']}
                used.update({f'{t}.{name}.0.weight', f'{t}.{name}.0.bias'})
        head['CompositeField4_0'] = {'Conv_0': {
            'kernel': _hwio(flat[f'{t}.head.conv.weight']),
            'bias': flat[f'{t}.head.conv.bias']}}
        used.update({f'{t}.head.conv.weight', f'{t}.head.conv.bias'})
        params[f'head_nets_{i}'] = head
        i += 1
    return params, used


def _cf3_to_cf4_channels(w, b, meta):
    """A CompositeField3 conv's output channels in the CompositeField4
    layout.

    CF3 channels per field: [conf (n_c), vectors (2 n_v), logb (n_v),
    scales (n_s)]; CF4: [b (1), conf, vectors, scales]. Only the first
    logb channel is kept, as the reference's own CF3 inference emits it
    ("v4 style").
    """
    n_c = meta.n_confidences
    n_v = meta.n_vectors
    n_s = meta.n_scales
    c3 = n_c + 3 * n_v + n_s
    c4 = 1 + n_c + 2 * n_v + n_s
    ups2 = meta.upsample_stride ** 2
    n_fields = w.shape[0] // (c3 * ups2)
    if n_fields * c3 * ups2 != w.shape[0]:
        raise ValueError(f'CompositeField3 conv of {w.shape[0]} channels is '
                         f'not {c3} x {ups2} per field')

    order = ([n_c + 2 * n_v]                       # first logb -> b
             + list(range(n_c))                    # confidences
             + list(range(n_c, n_c + 2 * n_v))     # vectors
             + list(range(n_c + 3 * n_v, c3)))     # scales
    assert len(order) == c4

    def reorder(arr):
        shaped = arr.reshape(n_fields, c3, ups2, *arr.shape[1:])
        return shaped[:, order].reshape(n_fields * c4 * ups2,
                                        *arr.shape[1:])

    return reorder(w), reorder(b)


def convert_heads(flat: Dict[str, np.ndarray], *, head_types=None,
                  head_metas=None):
    """CompositeField4/3 heads: ``head_nets.{i}.conv`` ->
    ``head_nets_{i}/Conv_0``, a CompositeField3 conv reordered into the
    CF4 layout."""
    params = {}
    used = set()
    i = 0
    while f'head_nets.{i}.conv.weight' in flat:
        w = flat[f'head_nets.{i}.conv.weight']
        b = flat[f'head_nets.{i}.conv.bias']
        if head_types is not None and i < len(head_types) \
                and head_types[i] == 'CompositeField3':
            if head_metas is None or i >= len(head_metas):
                raise ValueError(f'head {i}: a CompositeField3 needs its '
                                 'head meta')
            w, b = _cf3_to_cf4_channels(w, b, head_metas[i])
            LOG.info('head %d: CompositeField3 -> CF4 channel layout', i)
        params[f'head_nets_{i}'] = {'Conv_0': {'kernel': _hwio(w),
                                               'bias': b}}
        used.update({f'head_nets.{i}.conv.weight',
                     f'head_nets.{i}.conv.bias'})
        i += 1
    return params, used


def _arg(args, name):
    value = getattr(args, name, None)
    if value is None and isinstance(args, dict):
        value = args.get(name)
    return value


def detect_base_name(flat: Dict[str, np.ndarray], meta: dict) -> str:
    """The backbone's name from the checkpoint's ``args`` or, without
    them, from its weight names and shapes."""
    args = meta.get('args') if isinstance(meta, dict) else None
    basenet = None
    if args is not None:
        basenet = _arg(args, 'basenet')
        if not basenet:
            ckpt_name = _arg(args, 'checkpoint')
            if ckpt_name and str(ckpt_name) in \
                    set(_SHUFFLENET_REPEATS) | set(_RESNET_LAYERS):
                basenet = str(ckpt_name)
    if basenet:
        return str(basenet)

    if any(k.endswith('conv5.0.weight') for k in flat):
        stage2 = [k for k in flat if '.stage2.' in k]
        n2 = 1 + max(int(k.split('.stage2.')[1].split('.')[0])
                     for k in stage2)
        ch = None
        for k in flat:
            if k.endswith('stage2.0.branch1.2.weight'):
                ch = flat[k].shape[0] * 2
        for name, repeats in _SHUFFLENET_REPEATS.items():
            if repeats[0] != n2:
                continue
            from . import factory as models_factory
            with torch.device('meta'):
                net = models_factory.base_factory(name)()
            if ch is None or net.stages_out_channels[1] == ch:
                return name
    if any(k.endswith('backbone.3.squeeze.weight') for k in flat):
        return 'squeezenet'
    if any('.block.' in k and 'backbone.' in k for k in flat):
        return ('mobilenetv3large'
                if any(k.endswith('backbone.16.0.weight') for k in flat)
                else 'mobilenetv3small')
    if any(k.endswith('backbone.18.0.weight') for k in flat):
        return 'mobilenetv2'
    if any('.block2.' in k for k in flat):
        n4 = 1 + max(int(k.split('.block4.')[1].split('.')[0])
                     for k in flat if '.block4.' in k)
        if not any('.conv3.' in k for k in flat):
            return 'resnet18'
        grouped = any(k.endswith('block2.0.conv2.weight')
                      and flat[k].shape[1] != flat[k].shape[0]
                      for k in flat)
        by_n4 = {6: 'resnext50' if grouped else 'resnet50',
                 23: 'resnext101' if grouped else 'resnet101',
                 36: 'resnet152'}
        if n4 in by_n4:
            return by_n4[n4]
    raise ValueError('could not detect backbone architecture; '
                     'pass --base-name explicitly')


def convert_checkpoint(torch_path: str, *, base_name: str = None,
                       head_metas: List[headmeta.Base] = None):
    """A reference checkpoint file -> (base_name, head_metas, state dict
    of the port's Shell or TrackingShell, epoch).

    The pickled model's own head metas describe its heads; ``head_metas``
    serve only a bare state dict."""
    flat, epoch, meta, model_stub = load_torch_checkpoint(torch_path)

    tracking = any(k.startswith('base_net.single_image_backbone.')
                   for k in flat)
    base_prefix = ('base_net.single_image_backbone.' if tracking
                   else 'base_net.')

    if base_name is None:
        base_name = detect_base_name(flat, meta)
        if tracking and not base_name.startswith('t'):
            base_name = 't' + base_name
    if model_stub is not None:
        stub_metas = head_metas_from_stub(model_stub)
        if stub_metas:
            head_metas = stub_metas
    if not head_metas:
        raise ValueError('checkpoint has no recoverable head metas; '
                         'pass head_metas explicitly (e.g. via --dataset)')

    params, batch_stats, used = convert_base_net(
        flat, base_name, torch_prefix=base_prefix)
    if tracking:
        head_params, head_used = convert_tracking_heads(flat)
    else:
        head_params, head_used = convert_heads(
            flat, head_types=head_types_from_stub(model_stub),
            head_metas=head_metas)
    used |= head_used

    unused = [k for k in flat
              if k not in used and not k.endswith('num_batches_tracked')
              and '.flip_indices' not in k and '.reverse_direction' not in k]
    if unused:
        LOG.warning('unconverted torch weights: %s',
                    unused[:10] + (['...'] if len(unused) > 10 else []))

    state_dict = convert_jax.state_dict_from_jax({
        'params': {'base_net': params, **head_params},
        'batch_stats': {'base_net': batch_stats},
    })
    return base_name, head_metas, state_dict, epoch
