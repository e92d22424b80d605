"""Decoder factory (port of ``openpifpaf_tpu/decoder/factory.py``): the
registry of decoders, their flags, ``--decoder name[:i]`` selection and
the ``Multi`` over every decoder that the head metas admit.
"""

import argparse
import logging

from .cifcaf import CifCaf, CifCafDense
from .cifdet import CifDet
from .multi import Multi
from .pose_similarity import PoseSimilarity
from .tracking_pose import TrackingPose

LOG = logging.getLogger(__name__)

DECODERS = {CifCaf, CifCafDense, CifDet, TrackingPose, PoseSimilarity}

#: wrap every built decoder's ``batch_decode`` in a cProfile dump
profile_decoder = None


def cli(parser: argparse.ArgumentParser):
    group = parser.add_argument_group('decoder configuration')
    group.add_argument('--decoder', default=None, nargs='+',
                       help='decoders to be considered, e.g. "cifcaf:0"')
    group.add_argument('--decoder-workers', default=None, type=int,
                       help='compat flag: decoding is one process\'s '
                            'device work here, so this is accepted and '
                            'ignored, as in the JAX package')
    group.add_argument('--profile-decoder', default=None, nargs='?',
                       const='profile_decoder.prof',
                       help='profile the decoder and write a pstats file')
    group.add_argument('--decode-device', default=None, type=int,
                       help='decode on cuda:K on a side stream, the '
                            'fields copied there (out of range: on the '
                            'fields\' device, with one warning); with one '
                            'card only 0 exists, and the decode overlaps '
                            'the next forward on that card\'s side stream')
    group.add_argument('--cif-th', default=CifCaf.cifhr_threshold,
                       type=float, help='cif threshold')
    group.add_argument('--caf-th', default=CifCaf.caf_score_th,
                       type=float, help='caf threshold')
    for decoder in DECODERS:
        decoder.cli(parser)


def configure(args: argparse.Namespace):
    global profile_decoder
    CifCaf.decode_device = getattr(args, 'decode_device', None)
    profile_decoder = args.profile_decoder
    if args.decoder_workers:
        LOG.info('decoder workers requested (%d): decoding is one '
                 'process\'s device work, no worker pool needed',
                 args.decoder_workers)
    CifCaf.cifhr_threshold = args.cif_th
    CifCaf.caf_score_th = args.caf_th
    CifDet.cifhr_threshold = args.cif_th
    for decoder in DECODERS:
        decoder.configure(args)


def decoders(head_metas, requested=None):
    """The decoders of ``head_metas``, by decoder name; ``requested``
    (``--decoder``) selects by name or ``name:index``."""
    built = []
    for decoder_class in sorted(DECODERS, key=lambda d: d.__name__):
        instances = decoder_class.factory(head_metas)
        if requested is not None:
            name = decoder_class.__name__.lower()
            selected = []
            for request in requested:
                if ':' in request:
                    req_name, req_index = request.split(':')
                    if req_name == name:
                        selected.append(instances[int(req_index)])
                elif request == name:
                    selected.extend(instances)
            instances = selected
        built.extend(instances)
    return built


def factory(head_metas, requested=None) -> Multi:
    """A :class:`Multi` of :func:`decoders`; raises ``ValueError`` when
    there is none."""
    built = decoders(head_metas, requested)
    if profile_decoder:
        from ..profiler import Profiler
        for i, d in enumerate(built):
            suffix = f'.{type(d).__name__.lower()}{i}' if len(built) > 1 \
                else ''
            d.batch_decode = Profiler(d.batch_decode,
                                      out_name=profile_decoder + suffix)
    if not built:
        names = [type(m).__name__ for m in head_metas]
        raise ValueError(f'no decoders found for head metas {names}'
                         + (' (--dense-connections needs a dense Caf head)'
                            if CifCafDense.dense_coupling else ''))
    LOG.debug('built %d decoders', len(built))
    return Multi(built)
