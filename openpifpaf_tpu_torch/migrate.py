"""Migrate CLI of the port (counterpart of ``openpifpaf_tpu/migrate.py``):
re-save a checkpoint in the current layout.

    python -m openpifpaf_tpu_torch.migrate --checkpoint IN [--output OUT]

Two inputs:
  - a checkpoint of the port (``IN.json`` + ``IN.pt``), re-serialized
    through the current headmeta dataclasses;
  - a reference (PyTorch OpenPifPaf) ``.pkl``, converted
    (``models/convert_torch.py``) and saved as a checkpoint of the port
    with ``converted_from`` in its meta.

Runs on the CPU: nothing here touches a card.
"""

import argparse
import os

from . import __version__
from .training import checkpoint as ckpt_mod


def cli(argv=None):
    parser = argparse.ArgumentParser(
        prog='python3 -m openpifpaf_tpu_torch.migrate')
    parser.add_argument('--checkpoint', required=True,
                        help='checkpoint of the port, or a reference '
                             'PyTorch checkpoint file to convert')
    parser.add_argument('--output', default=None)
    parser.add_argument('--base-name', default=None,
                        help='override backbone detection for torch inputs')
    args = parser.parse_args(argv)
    if args.output is None:
        args.output = args.checkpoint + '.migrated'
    return args


def main(argv=None):
    args = cli(argv)

    if os.path.isfile(args.checkpoint) \
            and not os.path.exists(args.checkpoint + '.json'):
        from .models import convert_torch
        base_name, head_metas, state_dict, epoch = \
            convert_torch.convert_checkpoint(
                args.checkpoint, base_name=args.base_name)
        ckpt_mod.save(args.output, state_dict=state_dict, meta={
            'base_name': base_name,
            'head_metas': [ckpt_mod.headmeta_to_dict(m) for m in head_metas],
            'epoch': epoch,
            'version': __version__,
            'converted_from': os.path.abspath(args.checkpoint),
        })
        print(f'converted torch checkpoint ({base_name}) -> {args.output}')
        return

    state_dict, meta = ckpt_mod.load(args.checkpoint)
    metas = [ckpt_mod.headmeta_from_dict(d) for d in meta['head_metas']]
    meta['head_metas'] = [ckpt_mod.headmeta_to_dict(m) for m in metas]
    ckpt_mod.save(args.output, state_dict=state_dict, meta=meta)
    print(f'wrote {args.output}')


if __name__ == '__main__':
    main()
