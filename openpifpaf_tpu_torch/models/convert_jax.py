"""Weight bridge from the JAX package's flax variables to the port.

:func:`state_dict_from_jax` maps the flax auto-names of every backbone of
``openpifpaf_tpu/models/basenetworks.py`` and of the heads to the port's
module names:

- ShuffleNetV2K: ``base_net/ConvNormAct_0`` is the input block, a 3x3
  ``base_net/ConvNormAct_1`` is ``input_conv2`` and a 1x1 last
  ``base_net/ConvNormAct_*`` is conv5; ``base_net/InvertedResidualK_b`` is
  ``base_net.blocks.b`` (with ``conv5_as_stage``, the last two are
  ``base_net.conv5.0`` and ``.1``): five ``ConvNormAct`` for a stage's
  first block (branch1 then branch2), three for the others (branch2);
- Resnet: ``Conv_0`` and ``BatchNorm_0`` are ``stem.conv`` and
  ``stem.norm``, a ``ConvNormAct_0`` is ``input_conv2``;
  ``Bottleneck_b``/``BasicBlock_b`` is ``blocks.b``, its ``ConvNormAct_i``
  ``conv1``, ``conv2``, (``conv3``,) ``projection`` in that order;
- MobileNetV2/V3: ``ConvNormAct_0`` is ``stem``, ``ConvNormAct_1``
  ``conv_last``; ``InvertedResidualV2_b``'s ``ConvNormAct_i`` is
  ``blocks.b.convs.i``; ``InvertedResidualV3_b``'s last ``ConvNormAct``
  is ``blocks.b.project``, the others ``blocks.b.convs.i``, and its
  ``SqueezeExcite_0/Conv_0``, ``Conv_1`` are ``se.reduce``, ``se.expand``;
- SqueezeNet: ``Conv_0`` is ``stem.conv``; ``Fire_f``'s ``Conv_0``,
  ``Conv_1``, ``Conv_2`` are ``fires.f.squeeze``, ``expand1``,
  ``expand3``;
- a backbone of bare convs (the cifar10 plugin's ``Cifar10Net``):
  ``Conv_i`` is ``convs.i``;
- ``head_nets_i/Conv_0`` is ``head_nets.i.conv``; in a tracking shell,
  ``head_nets_i/CompositeField4_0/Conv_0`` is
  ``head_nets.i.composite_field.conv`` and a Tcaf head's
  ``feature_reduction`` and ``feature_compute`` keep their names.

A ``ConvNormAct``'s norm is its ``BatchNorm_0`` or ``GroupNorm_0``.
Kernels go from HWIO to OIHW (depthwise ``(K, K, 1, C)`` to ``(C, 1, K,
K)``), BatchNorm ``scale/bias/mean/var`` to
``weight/bias/running_mean/running_var``, GroupNorm ``scale/bias`` to
``weight/bias``. Every flax leaf must map to a port name and every mapped
layer must be complete, or it raises; :func:`load_jax_variables` then
loads strictly, so a port parameter that the flax tree lacks raises too.
"""

import re

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _index(name, kind):
    match = re.fullmatch(rf'{kind}_(\d+)', name)
    if match is None:
        raise KeyError(f'unexpected flax module {name!r} (wanted {kind}_i)')
    return int(match.group(1))


def _conv_norm_act_names(base_params):
    """Port module name for each ConvNormAct under ``base_net``, from the
    flax auto-names and, for the top-level ones after the input block, the
    kernel size: a 3x3 is ``input_conv2``, a 1x1 is ``conv5``. Without a
    1x1 conv5 the last two blocks are ``conv5`` (``conv5_as_stage``)."""
    blocks = {}
    for path in base_params:
        if path[0].startswith('InvertedResidualK_'):
            b = _index(path[0], 'InvertedResidualK')
            blocks.setdefault(b, set()).add(_index(path[1], 'ConvNormAct'))
    top = sorted({_index(path[0], 'ConvNormAct') for path in base_params
                  if path[0].startswith('ConvNormAct_')})
    if top[:1] != [0] or top != list(range(len(top))):
        raise KeyError(f'base_net ConvNormAct {top}: not a ShuffleNetV2K')
    names = {('ConvNormAct_0',): 'input_block'}
    sizes = {i: np.shape(base_params.get(
        (f'ConvNormAct_{i}', 'Conv_0', 'kernel')))[:1] for i in top[1:]}
    one_by_one = [i for i in top[1:] if sizes[i] == (1,)]
    three = [i for i in top[1:] if sizes[i] == (3,)]
    if len(one_by_one) + len(three) != len(top) - 1:
        raise KeyError(f'base_net ConvNormAct {top}: kernels of sizes '
                       f'{sizes}, wanted 3x3 or 1x1')
    if three not in ([], [1]) or len(one_by_one) > 1 \
            or one_by_one[-1:] not in ([], top[-1:]):
        raise KeyError(f'base_net ConvNormAct {top}: expected the input '
                       'block, an optional 3x3 input_conv2 and an optional '
                       '1x1 conv5')
    if three:
        names[('ConvNormAct_1',)] = 'input_conv2'
    block_names = {b: f'blocks.{b}' for b in blocks}
    if one_by_one:
        names[(f'ConvNormAct_{one_by_one[0]}',)] = 'conv5'
    else:
        if len(blocks) < 2:
            raise KeyError('base_net has no 1x1 conv5 and fewer than two '
                           'blocks to stand in for it')
        last = max(blocks)
        block_names[last - 1] = 'conv5.0'
        block_names[last] = 'conv5.1'
    for b, cnas in blocks.items():
        if cnas == set(range(5)):
            targets = ['branch1.0', 'branch1.1',
                       'branch2.0', 'branch2.1', 'branch2.2']
        elif cnas == set(range(3)):
            targets = ['branch2.0', 'branch2.1', 'branch2.2']
        else:
            raise KeyError(f'InvertedResidualK_{b} has ConvNormAct '
                           f'{sorted(cnas)}: not a ShuffleNetV2K block')
        for i, target in enumerate(targets):
            names[(f'InvertedResidualK_{b}', f'ConvNormAct_{i}')] = \
                f'{block_names[b]}.{target}'
    return names


def _children(base_params, prefix, kind):
    """Sorted indices i of the modules ``kind_i`` right under ``prefix``."""
    n = len(prefix)
    return sorted({_index(p[n], kind) for p in base_params
                   if p[:n] == prefix and len(p) > n + 1
                   and p[n].startswith(kind + '_')})


def _check_contiguous(indices, what):
    if indices != list(range(len(indices))):
        raise KeyError(f'{what} {indices}: not numbered 0..n-1')


def _resnet_layers(base_params):
    layers = {('Conv_0',): ('stem.conv', 'conv'),
              ('BatchNorm_0',): ('stem.norm', 'bn')}
    top = _children(base_params, (), 'ConvNormAct')
    if top not in ([], [0]):
        raise KeyError(f'base_net ConvNormAct {top}: a Resnet has at most '
                       'input_conv2')
    if top:
        layers[('ConvNormAct_0',)] = ('input_conv2', 'cna')
    kinds = {'Bottleneck': ('conv1', 'conv2', 'conv3', 'projection'),
             'BasicBlock': ('conv1', 'conv2', 'projection')}
    found = [kind for kind in kinds if _children(base_params, (), kind)]
    if len(found) != 1:
        raise KeyError(f'base_net has blocks of kinds {found}: not a Resnet')
    kind = found[0]
    targets = kinds[kind]
    blocks = _children(base_params, (), kind)
    _check_contiguous(blocks, f'base_net {kind}')
    for b in blocks:
        cnas = _children(base_params, (f'{kind}_{b}',), 'ConvNormAct')
        if cnas not in (list(range(len(targets) - 1)),
                        list(range(len(targets)))):
            raise KeyError(f'{kind}_{b} has ConvNormAct {cnas}')
        for i in cnas:
            layers[(f'{kind}_{b}', f'ConvNormAct_{i}')] = (
                f'blocks.{b}.{targets[i]}', 'cna')
    return layers


def _mobilenet_layers(base_params, kind):
    top = _children(base_params, (), 'ConvNormAct')
    if top != [0, 1]:
        raise KeyError(f'base_net ConvNormAct {top}: a MobileNet has the '
                       'stem and the last conv')
    layers = {('ConvNormAct_0',): ('stem', 'cna'),
              ('ConvNormAct_1',): ('conv_last', 'cna')}
    blocks = _children(base_params, (), kind)
    _check_contiguous(blocks, f'base_net {kind}')
    for b in blocks:
        block = (f'{kind}_{b}',)
        cnas = _children(base_params, block, 'ConvNormAct')
        if cnas not in ([0, 1], [0, 1, 2]):
            raise KeyError(f'{kind}_{b} has ConvNormAct {cnas}')
        for i in cnas:
            name = 'project' if kind == 'InvertedResidualV3' \
                and i == cnas[-1] else f'convs.{i}'
            layers[block + (f'ConvNormAct_{i}',)] = (f'blocks.{b}.{name}',
                                                     'cna')
        if kind == 'InvertedResidualV3' and _children(
                base_params, block, 'SqueezeExcite'):
            for i, name in enumerate(('reduce', 'expand')):
                layers[block + ('SqueezeExcite_0', f'Conv_{i}')] = (
                    f'blocks.{b}.se.{name}', 'conv')
    return layers


def _squeezenet_layers(base_params):
    layers = {('Conv_0',): ('stem.conv', 'conv')}
    fires = _children(base_params, (), 'Fire')
    _check_contiguous(fires, 'base_net Fire')
    for f in fires:
        for i, name in enumerate(('squeeze', 'expand1', 'expand3')):
            layers[(f'Fire_{f}', f'Conv_{i}')] = (f'fires.{f}.{name}', 'conv')
    return layers


def _base_net_layers(base_params):
    """{flax module path under ``base_net``: (port module name, kind)},
    kind 'cna' (a ConvNormAct), 'conv' (a conv, biased or not) or 'bn'
    (a bare BatchNorm), for the backbone family the names belong to."""
    kinds = {path[0].rsplit('_', 1)[0] for path in base_params}
    if 'InvertedResidualK' in kinds:
        return {path: (name, 'cna') for path, name in
                _conv_norm_act_names(base_params).items()}
    if kinds & {'Bottleneck', 'BasicBlock'}:
        return _resnet_layers(base_params)
    for kind in ('InvertedResidualV2', 'InvertedResidualV3'):
        if kind in kinds:
            return _mobilenet_layers(base_params, kind)
    if 'Fire' in kinds:
        return _squeezenet_layers(base_params)
    if kinds == {'Conv'}:
        convs = _children(base_params, (), 'Conv')
        _check_contiguous(convs, 'base_net Conv')
        return {(f'Conv_{i}',): (f'convs.{i}', 'conv') for i in convs}
    raise KeyError(f'base_net modules {sorted(kinds)}: no backbone family '
                   'of the JAX package')


def _conv_weight(kernel):
    if kernel.ndim != 4:
        raise ValueError(f'conv kernel must be HWIO, got {kernel.shape}')
    return kernel.transpose(3, 2, 0, 1)


def state_dict_from_jax(variables):
    """The port's ``state_dict`` from flax variables (nested dicts of numpy
    arrays with ``params`` and ``batch_stats``)."""
    params = dict(_flatten(variables['params']))
    stats = dict(_flatten(variables.get('batch_stats', {})))
    used = set()
    out = {}

    def take(tree, path, name):
        if path not in tree:
            raise KeyError(f'flax variable {"/".join(path)} missing '
                           f'(for {name})')
        used.add((id(tree), path))
        return tree[path]

    def conv(f, t):
        out[f'{t}.weight'] = _conv_weight(take(params, f + ('kernel',), t))
        if f + ('bias',) in params:
            out[f'{t}.bias'] = take(params, f + ('bias',), t)

    def batch_norm(f, t):
        out[f'{t}.weight'] = take(params, f + ('scale',), t)
        out[f'{t}.bias'] = take(params, f + ('bias',), t)
        out[f'{t}.running_mean'] = take(stats, f + ('mean',), t)
        out[f'{t}.running_var'] = take(stats, f + ('var',), t)
        out[f'{t}.num_batches_tracked'] = np.zeros((), np.int64)

    layers = _base_net_layers(
        {p[1:]: v for p, v in params.items() if p[0] == 'base_net'})
    for module_path, (name, kind) in layers.items():
        f = ('base_net',) + module_path
        t = f'base_net.{name}'
        if kind == 'conv':
            conv(f, t)
        elif kind == 'bn':
            batch_norm(f, t)
        else:
            conv(f + ('Conv_0',), f'{t}.conv')
            if f + ('GroupNorm_0', 'scale') in params:
                g = f + ('GroupNorm_0',)
                out[f'{t}.norm.weight'] = take(params, g + ('scale',), t)
                out[f'{t}.norm.bias'] = take(params, g + ('bias',), t)
            else:
                batch_norm(f + ('BatchNorm_0',), f'{t}.norm')

    heads = sorted({_index(p[0], 'head_nets') for p in params
                    if p[0].startswith('head_nets_')})
    for i in heads:
        f = (f'head_nets_{i}',)
        t = f'head_nets.{i}'
        if f + ('Conv_0', 'kernel') in params:
            conv(f + ('Conv_0',), f'{t}.conv')
            continue
        # a tracking head: the CompositeField4 inside, and a Tcaf head's
        # two convs
        conv(f + ('CompositeField4_0', 'Conv_0'), f'{t}.composite_field.conv')
        names = ('feature_reduction', 'feature_compute')
        if any(f + (name, 'kernel') in params for name in names):
            for name in names:
                conv(f + (name,), f'{t}.{name}')

    left = sorted('/'.join(p) for tree in (params, stats) for p in tree
                  if (id(tree), p) not in used)
    if left:
        raise KeyError(f'flax variables with no port counterpart: {left}')
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def load_jax_variables(model, variables):
    """Load flax variables into a port ``Shell`` (or ``TrackingShell``)
    strictly: a parameter on either side without a counterpart raises."""
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model
