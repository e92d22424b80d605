"""Convert a checkpoint of the JAX package into one of the PyTorch port.

    python tools/convert_jax_checkpoint.py SRC DST

SRC is the JAX package's checkpoint path (``SRC.json`` and the orbax
directory ``SRC.arrays``, as its trainer writes them); DST is written as
the port's checkpoint (``DST.json`` with the same meta, ``DST.pt`` with
the state dict of ``models/convert_jax.py::state_dict_from_jax``). The
script reads orbax through the JAX package, so it runs where JAX is
installed; the port then serves DST without JAX
(``python -m openpifpaf_tpu_torch.predict --checkpoint DST``).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..'))


def convert(src, dst):
    """Write the port's checkpoint ``dst`` from the JAX checkpoint
    ``src``; returns ``dst``."""
    from openpifpaf_tpu.training import checkpoint as jax_checkpoint
    from openpifpaf_tpu_torch.models import convert_jax
    from openpifpaf_tpu_torch.training import checkpoint as port_checkpoint

    arrays, meta = jax_checkpoint.load(src)
    state_dict = convert_jax.state_dict_from_jax(
        {'params': arrays['params'], 'batch_stats': arrays['batch_stats']})
    port_checkpoint.save(dst, state_dict=state_dict, meta=meta)
    return dst


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='python3 tools/convert_jax_checkpoint.py',
        description=__doc__.split('\n\n')[0])
    parser.add_argument('src', help='JAX checkpoint (path without '
                                    '.json/.arrays)')
    parser.add_argument('dst', help='port checkpoint to write (path '
                                    'without .json/.pt)')
    args = parser.parse_args(argv)
    print(convert(args.src, args.dst))


if __name__ == '__main__':
    main()
