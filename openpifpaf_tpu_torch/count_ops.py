"""Count-ops CLI of the port (counterpart of
``openpifpaf_tpu/count_ops.py``): GFLOPs and parameters of a model's
forward on one 641x641 image, (1, 3, 641, 641) at the backbone, through
the module graph.

    python -m openpifpaf_tpu_torch.count_ops --checkpoint shufflenetv2k16

The operations come from ``torch.utils.flop_counter.FlopCounterMode``,
which counts two per multiply-add of the convolutions and matmuls and
nothing else. The JAX package reads XLA's ``cost_analysis``, which also
counts the elementwise work (BatchNorm, ReLU, the heads' sigmoid and
softplus), so its figure is the larger: for shufflenetv2k16 with the
cocokp heads, by less than 1% at 161x161 and at 321x321 on the CPU
(``tests/test_torch_checkpoint_names.py::test_count_ops_matches_jax``).
Parameter counts are equal.

It runs on the first CUDA device and raises without one; ``--device cpu``
runs on the CPU.
"""

import argparse

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import datasets
from .models import factory as models_factory
from .training import checkpoint as ckpt_mod


def count(model, *, input_shape=(1, 641, 641, 3), device='cpu'):
    """(GFLOPs, million parameters) of ``model``'s forward on zeros of
    ``input_shape`` (NHWC, as the Shell takes images)."""
    model = model.to(device).eval()
    image = torch.zeros(input_shape, dtype=torch.float32, device=device)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model(image)
    n_params = sum(p.numel() for p in model.parameters())
    return counter.get_total_flops() / 1e9, n_params / 1e6


def cli(argv=None):
    parser = argparse.ArgumentParser(
        prog='python3 -m openpifpaf_tpu_torch.count_ops')
    parser.add_argument('--checkpoint', default=None)
    parser.add_argument('--basenet', default='shufflenetv2k16')
    parser.add_argument('--dataset', default='cocokp')
    parser.add_argument('--device', default='cuda',
                        help='torch device of the forward; "cpu" runs on '
                             'the CPU')
    return parser.parse_args(argv)


def main(argv=None):
    args = cli(argv)
    if args.device.startswith('cuda') and not torch.cuda.is_available():
        raise RuntimeError('count_ops: no CUDA device found; pass '
                           '--device cpu to count on the CPU')

    if args.checkpoint:
        model, _ = ckpt_mod.load_shell(args.checkpoint)
    else:
        datamodule = datasets.factory(args.dataset)
        model = models_factory.Factory(base_name=args.basenet).from_scratch(
            datamodule.head_metas)

    gflops, mparams = count(model, device=args.device)
    print(f'GFLOPS: {gflops:.2f}')
    print(f'million parameters: {mparams:.2f}')
    return gflops, mparams


if __name__ == '__main__':
    main()
