"""Model export CLI (port of ``openpifpaf_tpu/export.py``).

Writes the forward, and with ``--with-decoder`` the forward and the
fixed-budget CifCaf decode, as ONE ``torch.export`` program: a ``.pt2``
file (``torch.export.save``), the port's counterpart of JAX's StableHLO.
The decode's loops are in the program (the fixpoints as the operator of
``torch.while_loop``, the growth as masked steps), and the CifHr kernel is
the operator ``torch.ops.openpifpaf_tpu_torch.cifhr_accumulate``. A program
written with the decoder therefore loads in a process that has imported
``openpifpaf_tpu_torch``, which registers that operator:

    import torch, openpifpaf_tpu_torch
    program = torch.export.load('k16.pt2').module()
    poses, keep, order = program(image)   # (1, H, W, 3) float32, NHWC

``--format savedmodel`` is the C++ runner's input, as JAX's SavedModel
is: the same program compiled ahead of time by AOTInductor
(``torch._inductor.aoti_compile_and_package``) into a package, with the
decoder returning (poses, keep) and without it the fields. The runner
(``openpifpaf_tpu_torch/cpp/``, built by :mod:`.cpp_runner`) loads it
with LibTorch and its own CifHr operator (``csrc/cifhr_op.cpp``); in
Python ``torch._inductor.aoti_load_package`` loads it after ``import
openpifpaf_tpu_torch``.

The program runs on the device it was exported on (``--device``, the card
by default). The decode in it is the standard tier: a crowded image is not
escalated to the crowd tier, as in JAX's export.

Example:
    python -m openpifpaf_tpu_torch.export --checkpoint model --outfile k16.pt2
    python -m openpifpaf_tpu_torch.export --with-decoder --outfile k16.pt2
    python -m openpifpaf_tpu_torch.export --format savedmodel \
        --with-decoder --outfile k16-package.pt2
"""

import argparse
import logging
import os
import subprocess

import torch

from . import datasets
from .models import factory as models_factory

LOG = logging.getLogger(__name__)

#: formats of JAX's export that have no counterpart in the port yet, and
#: the ROADMAP item of each
NOT_PORTED = {
    'tflite': 'the mobile format waits for a mobile runtime (ExecuTorch) '
              'on the machines (ROADMAP A13(i))',
}


class Program(torch.nn.Module):
    """``forward(image)``, image (B, H, W, 3) float32 NHWC: the model's
    fields or, with ``decode``, the first ``n_outputs`` outputs of
    ``decode(cif, caf)``."""

    def __init__(self, model, decode=None, n_outputs=None):
        super().__init__()
        self.model = model
        self.decode = decode
        self.n_outputs = n_outputs

    def forward(self, image):
        fields = self.model(image)
        if self.decode is None:
            return fields
        return self.decode(*fields[:2])[:self.n_outputs]


def _decoder(head_metas):
    from .ops.decode_cifcaf import build_cifcaf_decoder
    cif_meta, caf_meta = head_metas[:2]
    return build_cifcaf_decoder(stride=cif_meta.stride,
                                skeleton=caf_meta.skeleton,
                                n_keypoints=len(cif_meta.keypoints))


def _build_forward(model, *, with_decoder, head_metas, n_outputs=2):
    """image -> fields or, with the decoder, the first ``n_outputs`` of
    (poses (B, P, K, 4), keep (B, P), order (B, P)); the default is the
    C++ runner's (poses, keep)."""
    if with_decoder:
        return Program(model, _decoder(head_metas), n_outputs=n_outputs)
    return Program(model)


def export_program(model, *, input_shape=(1, 481, 641, 3),
                   with_decoder=False, head_metas=None, device='cuda',
                   n_outputs=3):
    """A ``torch.export.ExportedProgram`` of the NHWC float32 forward of
    ``model`` on ``device`` (the counterpart of JAX's
    ``export_stablehlo``); with the decoder it returns (poses, keep,
    order), or its first ``n_outputs``, of the CifCaf decode at
    ``CifCafDecoderConfig()``'s defaults.
    ``model`` is moved to ``device``, put in eval mode and its parameters
    stop requiring gradients (so that the program's outputs do not)."""
    model = model.to(device).eval().requires_grad_(False)
    if with_decoder:
        head_metas = head_metas or model.head_metas
    program = _build_forward(model, with_decoder=with_decoder,
                             head_metas=head_metas, n_outputs=n_outputs)
    image = torch.zeros(input_shape, dtype=torch.float32, device=device)
    with torch.no_grad():
        return torch.export.export(program, (image,))


_OPENMP_PROBE = ('#include <omp.h>\n'
                 'int threads() { return omp_get_max_threads(); }\n')


def openmp_cxx(directory):
    """The C++ compiler for AOTInductor: ``$CXX`` or ``g++``, the first
    that links an OpenMP shared library (the package's host kernels, such
    as the loops' flags on the CPU, use OpenMP); a probe compiled in
    ``directory``."""
    candidates = [c for c in (os.environ.get('CXX'), 'g++') if c]
    source = os.path.join(directory, 'openmp_probe.cpp')
    with open(source, 'w') as f:
        f.write(_OPENMP_PROBE)
    errors = []
    for cxx in candidates:
        try:
            done = subprocess.run(
                [cxx, '-fopenmp', '-shared', '-fPIC', source, '-o',
                 os.path.join(directory, 'openmp_probe.so')],
                capture_output=True, text=True, timeout=120, check=False)
        except OSError as e:
            errors.append(f'{cxx}: {e}')
            continue
        if done.returncode == 0:
            return cxx
        errors.append(f'{cxx}: {done.stderr.strip()[-300:]}')
    raise RuntimeError('export: no C++ compiler links OpenMP, which '
                       'AOTInductor\'s package needs: ' + '; '.join(errors))


def compile_package(program, outfile):
    """AOTInductor package of ``program`` (an ``ExportedProgram``) at
    ``outfile``, for the device it was exported on, compiled with
    :func:`openmp_cxx`'s compiler (probed in the kernels' build
    directory). Its metadata's ``input_shape``
    (``'1,481,641,3'``) is the first input's shape: the package checks no
    shape, so the C++ runner reads it."""
    from torch._inductor import aoti_compile_and_package, config

    from . import _nvcc

    os.makedirs(_nvcc.BUILD_DIR, exist_ok=True)
    cxx = openmp_cxx(_nvcc.BUILD_DIR)
    LOG.info('AOTInductor compiles with %s', cxx)
    saved = os.environ.get('CXX')
    os.environ['CXX'] = cxx   # for Inductor's compile workers
    try:
        first = next(n for n in program.graph.nodes
                     if n.op == 'placeholder'
                     and n.name in program.graph_signature.user_inputs)
        metadata = {'input_shape': ','.join(
            str(int(d)) for d in first.meta['val'].shape)}
        with config.patch({'cpp.cxx': (None, cxx),
                           'aot_inductor.metadata': metadata}):
            return aoti_compile_and_package(program, package_path=outfile)
    finally:
        if saved is None:
            del os.environ['CXX']
        else:
            os.environ['CXX'] = saved


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='python3 -m openpifpaf_tpu_torch.export',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('--checkpoint', default=None)
    parser.add_argument('--basenet', default='shufflenetv2k16')
    parser.add_argument('--dataset', default='cocokp')
    parser.add_argument('--outfile', default='openpifpaf_tpu_torch.pt2')
    parser.add_argument('--input-height', type=int, default=481)
    parser.add_argument('--input-width', type=int, default=641)
    parser.add_argument('--with-decoder', default=False, action='store_true',
                        help='include the CifCaf decode pipeline in the '
                             'exported program')
    parser.add_argument('--format', default='pt2',
                        choices=('pt2', 'savedmodel', 'tflite'),
                        help='pt2: a torch.export program '
                             '(torch.export.save); savedmodel: the C++ '
                             'runner\'s input, in the port an AOTInductor '
                             'package of the same program (with the decoder '
                             'it returns (poses, keep)); tflite is not '
                             'ported (it raises)')
    parser.add_argument('--device', default='cuda',
                        help='torch device the program is exported for '
                             'and runs on; "cpu" exports for the CPU')
    args = parser.parse_args(argv)

    if args.format in NOT_PORTED:
        raise NotImplementedError(f'--format {args.format} is not ported to '
                                  f'PyTorch: {NOT_PORTED[args.format]}')
    if args.device.startswith('cuda') and not torch.cuda.is_available():
        raise RuntimeError('export: no CUDA device found; pass --device cpu '
                           'to export for the CPU')

    if args.checkpoint:
        from .training import checkpoint as ckpt_mod
        model, _ = ckpt_mod.load_shell(args.checkpoint)
        head_metas = model.head_metas
    else:
        datamodule = datasets.factory(args.dataset)
        net_factory = models_factory.Factory(base_name=args.basenet)
        model = net_factory.from_scratch(
            datamodule.head_metas,
            generator=torch.Generator().manual_seed(0))
        head_metas = datamodule.head_metas

    savedmodel = args.format == 'savedmodel'
    program = export_program(
        model, input_shape=(1, args.input_height, args.input_width, 3),
        with_decoder=args.with_decoder, head_metas=head_metas,
        device=args.device, n_outputs=2 if savedmodel else 3)
    if savedmodel:
        compile_package(program, args.outfile)
    else:
        torch.export.save(program, args.outfile)
    LOG.info('wrote %s (%d bytes)', args.outfile,
             os.path.getsize(args.outfile))
    print(f'wrote {args.outfile}')


if __name__ == '__main__':
    main()
