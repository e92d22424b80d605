"""Checkpoints of the port: the JAX package's ``.json`` meta beside a
``.pt`` state dict (counterpart of ``openpifpaf_tpu/training/checkpoint.py``).

A checkpoint ``path`` is two files:

- ``path.json``: the same meta as the JAX package writes (``base_name``,
  ``backbone_options``, ``head_metas`` through :func:`headmeta_to_dict`,
  ``epoch``, ``args``, ``version``), from which the Shell is rebuilt;
- ``path.pt``: the model's state dict (the trainer writes the EMA
  parameters and the current BatchNorm buffers), read with
  ``torch.load(weights_only=True)``.

A single file with no ``path.json`` beside it is a reference (PyTorch
OpenPifPaf) checkpoint, a ``.pkl``: :func:`load_shell` converts it in
memory (``models/convert_torch.py``), as the JAX package does.

The JAX package's orbax directories (``path.arrays``) are not read: the
machine the port runs on has no orbax, and the port may not import it.
``tools/convert_jax_checkpoint.py SRC DST`` converts one where the JAX
package is installed.
"""

import dataclasses
import json
import logging
import os

import numpy as np
import torch

from .. import headmeta

LOG = logging.getLogger(__name__)

HEADMETA_CLASSES = {cls.__name__: cls for cls in (
    headmeta.Cif, headmeta.Caf, headmeta.CifDet, headmeta.TSingleImageCif,
    headmeta.TSingleImageCaf, headmeta.Tcaf)}


def headmeta_to_dict(meta):
    d = {'__class__': type(meta).__name__}
    for f in dataclasses.fields(meta):
        value = getattr(meta, f.name)
        if isinstance(value, np.ndarray):
            value = {'__ndarray__': value.tolist()}
        d[f.name] = value
    d['head_index'] = meta.head_index
    d['base_stride'] = meta.base_stride
    d['upsample_stride'] = meta.upsample_stride
    return d


def headmeta_from_dict(d):
    d = dict(d)
    name = d.pop('__class__')
    if name not in HEADMETA_CLASSES:
        raise ValueError(f'unknown head meta {name!r}; '
                         f'known: {sorted(HEADMETA_CLASSES)}')
    cls = HEADMETA_CLASSES[name]
    head_index = d.pop('head_index', None)
    base_stride = d.pop('base_stride', None)
    upsample_stride = d.pop('upsample_stride', 1)
    init_fields = {f.name for f in dataclasses.fields(cls) if f.init}
    kwargs = {}
    for k, v in d.items():
        if k not in init_fields:
            continue
        if isinstance(v, dict) and '__ndarray__' in v:
            v = np.asarray(v['__ndarray__'])
        kwargs[k] = v
    meta = cls(**kwargs)
    meta.head_index = head_index
    meta.base_stride = base_stride
    meta.upsample_stride = upsample_stride
    return meta


def save(path, *, state_dict, meta):
    path = os.path.abspath(path)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()},
               path + '.pt')
    with open(path + '.json', 'w') as f:
        json.dump(meta, f)


def load(path):
    """(state dict on the CPU, meta) of the checkpoint at ``path``."""
    path = os.path.abspath(path)
    with open(path + '.json', 'r') as f:
        meta = json.load(f)
    if not os.path.exists(path + '.pt') \
            and os.path.isdir(path + '.arrays'):
        raise NotImplementedError(
            f'{path}: an orbax checkpoint of the JAX package; convert it '
            'with tools/convert_jax_checkpoint.py where the JAX package is '
            'installed')
    state_dict = torch.load(path + '.pt', map_location='cpu',
                            weights_only=True)
    return state_dict, meta


def load_shell(path, *, head_metas=None,
               head_consolidation='filter_and_extend'):
    """(Shell with the checkpoint's weights, meta), on the CPU; a
    TrackingShell for tracking metas.

    ``path`` is a checkpoint of the port or a reference ``.pkl`` (a file
    with no ``path.json``), converted in memory; its meta then holds the
    ``base_name``, ``epoch`` and ``head_metas`` of the conversion, and
    its own head metas win over ``head_metas`` (which serve a bare state
    dict).

    head_consolidation:
      'keep' — ignore the requested head_metas, use the checkpoint's heads;
      'create' — all requested heads freshly initialized;
      'filter_and_extend' — reuse checkpoint weights for requested heads
        that match by (dataset, name), initialize the rest.
    New heads are initialized like flax from seed 0.
    """
    from ..models import factory as models_factory
    from ..models.shell import assign_strides

    if os.path.isfile(path) and not os.path.exists(path + '.json'):
        from ..models import convert_torch
        base_name, ckpt_metas, state_dict, epoch = \
            convert_torch.convert_checkpoint(path, head_metas=head_metas)
        meta = {'base_name': base_name, 'epoch': epoch,
                'head_metas': [headmeta_to_dict(m) for m in ckpt_metas]}
    else:
        state_dict, meta = load(path)
        ckpt_metas = [headmeta_from_dict(d) for d in meta['head_metas']]

    # models trained with backbone flags (--shufflenetv2k-*, --resnet-*)
    # record the options; apply them only while building the backbone
    targets = {'shufflenetv2k': models_factory.SHUFFLENETV2K_OPTIONS,
               'resnet': models_factory.RESNET_OPTIONS}
    snapshot = {family: dict(options) for family, options in targets.items()}
    for family, options in (meta.get('backbone_options') or {}).items():
        if family in targets:
            targets[family].update(options)
    try:
        base_net = models_factory.base_factory(meta['base_name'])()
    finally:
        for family, options in targets.items():
            options.clear()
            options.update(snapshot[family])

    if head_metas is None or head_consolidation == 'keep':
        assign_strides(ckpt_metas, base_net.stride)
        model = models_factory.build_shell(base_net, ckpt_metas)
        model.load_state_dict(state_dict, strict=True)
        return model, meta

    if head_consolidation not in ('create', 'filter_and_extend'):
        raise ValueError(f'unknown head consolidation {head_consolidation}')
    assign_strides(head_metas, base_net.stride)
    model = models_factory.build_shell(base_net, head_metas)
    merged = model.state_dict()
    for name, value in state_dict.items():
        if name.startswith('base_net.'):
            merged[name] = value
    if head_consolidation == 'filter_and_extend':
        ckpt_by_key = {(m.dataset, m.name): i
                       for i, m in enumerate(ckpt_metas)}
        for i, m in enumerate(head_metas):
            ckpt_i = ckpt_by_key.get((m.dataset, m.name))
            if ckpt_i is None:
                LOG.info('initializing new head %s.%s', m.dataset, m.name)
                continue
            src = f'head_nets.{ckpt_i}.'
            for name, value in state_dict.items():
                if name.startswith(src):
                    merged[f'head_nets.{i}.' + name[len(src):]] = value
    model.load_state_dict(merged, strict=True)
    return model, meta
