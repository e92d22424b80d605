"""Weight bridge from the JAX package's flax variables to the port.

:func:`state_dict_from_jax` inverts the flax names that
``openpifpaf_tpu/models/convert_torch.py::_map_shufflenetv2k`` writes for
a ShuffleNetV2K ``Shell``:

- ``base_net/ConvNormAct_0`` is the input block and the last
  ``base_net/ConvNormAct_*`` is conv5;
- ``base_net/InvertedResidualK_b`` is ``base_net.blocks.b``: five
  ``ConvNormAct`` for a stage's first block (branch1 then branch2), three
  for the others (branch2);
- ``head_nets_i/Conv_0`` is ``head_nets.i.conv``.

Kernels go from HWIO to OIHW (depthwise ``(K, K, 1, C)`` to
``(C, 1, K, K)``), BatchNorm ``scale/bias/mean/var`` to
``weight/bias/running_mean/running_var``. Every flax leaf must map to a
port name and every mapped layer must be complete, or it raises;
:func:`load_jax_variables` then loads strictly, so a port parameter that
the flax tree lacks raises too.
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


def _conv_norm_act_names(base_path):
    """Port module name for each ConvNormAct under ``base_net``."""
    blocks = {}
    for path in base_path:
        if path[0].startswith('InvertedResidualK_'):
            b = _index(path[0], 'InvertedResidualK')
            blocks.setdefault(b, set()).add(_index(path[1], 'ConvNormAct'))
    names = {}
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
                f'blocks.{b}.{target}'
    top = sorted({_index(path[0], 'ConvNormAct') for path in base_path
                  if path[0].startswith('ConvNormAct_')})
    if top != [0, 1]:
        raise KeyError(f'base_net ConvNormAct {top}: only the input block '
                       'and conv5 are ported (no input_conv2)')
    names[('ConvNormAct_0',)] = 'input_block'
    names[('ConvNormAct_1',)] = 'conv5'
    return names


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

    base_paths = [p[1:] for p in params if p[0] == 'base_net']
    cna_names = _conv_norm_act_names(base_paths)
    for module_path, name in cna_names.items():
        f = ('base_net',) + module_path
        t = f'base_net.{name}'
        out[f'{t}.conv.weight'] = _conv_weight(
            take(params, f + ('Conv_0', 'kernel'), t))
        out[f'{t}.norm.weight'] = take(params, f + ('BatchNorm_0', 'scale'), t)
        out[f'{t}.norm.bias'] = take(params, f + ('BatchNorm_0', 'bias'), t)
        out[f'{t}.norm.running_mean'] = take(
            stats, f + ('BatchNorm_0', 'mean'), t)
        out[f'{t}.norm.running_var'] = take(
            stats, f + ('BatchNorm_0', 'var'), t)
        out[f'{t}.norm.num_batches_tracked'] = np.zeros((), np.int64)

    heads = sorted(_index(p[0], 'head_nets') for p in params
                   if p[0].startswith('head_nets_') and p[1:] == (
                       'Conv_0', 'kernel'))
    for i in heads:
        f = (f'head_nets_{i}', 'Conv_0')
        t = f'head_nets.{i}.conv'
        out[f'{t}.weight'] = _conv_weight(take(params, f + ('kernel',), t))
        out[f'{t}.bias'] = take(params, f + ('bias',), t)

    left = sorted('/'.join(p) for tree in (params, stats) for p in tree
                  if (id(tree), p) not in used)
    if left:
        raise KeyError(f'flax variables with no port counterpart: {left}')
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def load_jax_variables(model, variables):
    """Load flax variables into a port ``Shell`` strictly: a parameter on
    either side without a counterpart raises."""
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model
