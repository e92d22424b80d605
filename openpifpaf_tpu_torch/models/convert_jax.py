"""Weight bridge from the JAX package's flax variables to the port.

:func:`state_dict_from_jax` inverts the flax names that
``openpifpaf_tpu/models/convert_torch.py::_map_shufflenetv2k`` writes for
a ShuffleNetV2K ``Shell``:

- ``base_net/ConvNormAct_0`` is the input block, a 3x3
  ``base_net/ConvNormAct_1`` is ``input_conv2`` and a 1x1 last
  ``base_net/ConvNormAct_*`` is conv5;
- ``base_net/InvertedResidualK_b`` is ``base_net.blocks.b`` (with
  ``conv5_as_stage``, the last two are ``base_net.conv5.0`` and ``.1``):
  five ``ConvNormAct`` for a stage's first block (branch1 then branch2),
  three for the others (branch2);
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

    cna_names = _conv_norm_act_names(
        {p[1:]: v for p, v in params.items() if p[0] == 'base_net'})
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
