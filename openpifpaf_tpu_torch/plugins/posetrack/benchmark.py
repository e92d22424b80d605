"""Tracking benchmark wrapper (copy of
``openpifpaf_tpu/plugins/posetrack/benchmark.py``): runs the port's
generic benchmark with posetrack defaults and tracking-specific ablation
suites. Eval flags it does not know, such as ``--device cpu``, go
through to each eval unchanged. Its ``--crowdpose`` mode needs the
crowdpose data module, which is not ported yet (ROADMAP A16): it raises.

    python -m openpifpaf_tpu_torch.plugins.posetrack.benchmark \
        --checkpoints CKPT --ablation-1
"""

import argparse
import datetime
import logging

from ...benchmark import Benchmark

LOG = logging.getLogger(__name__)

DEFAULT_CHECKPOINTS = ['tshufflenetv2k16']


def cli(argv=None):
    parser = argparse.ArgumentParser(
        prog='python3 -m openpifpaf_tpu_torch.plugins.posetrack.benchmark',
        description=__doc__,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('--output', default=None)
    parser.add_argument('--checkpoints', default=DEFAULT_CHECKPOINTS,
                        nargs='+')
    parser.add_argument('--crowdpose', default=False, action='store_true')
    parser.add_argument('--ablation-1', default=False, action='store_true',
                        help='greedy / reverse-match decoder ablations')
    parser.add_argument('--ablation-2', default=False, action='store_true',
                        help='no-rescore / nms seed ablations')
    parser.add_argument('--ablation-3', default=False, action='store_true',
                        help='pose-similarity tracker distances')
    parser.add_argument('--ablation-4', default=False, action='store_true',
                        help='eval resolutions')
    parser.add_argument('--ablation-5', default=False, action='store_true',
                        help='track recovery')
    parser.add_argument('--debug', default=False, action='store_true')
    args, eval_args = parser.parse_known_args(argv)
    if args.crowdpose:
        raise NotImplementedError(
            '--crowdpose needs the crowdpose data module, which is not '
            'yet ported to PyTorch (ROADMAP A16)')

    logging.basicConfig(
        level=logging.INFO if not args.debug else logging.DEBUG)

    if not any(a.startswith('--loader-workers') for a in eval_args):
        eval_args.append('--loader-workers=2')

    dataset = None
    if not any(a.startswith('--dataset') for a in eval_args):
        dataset = 'posetrack2018'
        if not any(a.startswith('--write-predictions') for a in eval_args):
            eval_args.append('--write-predictions')
        if not any(a.startswith('--decoder') for a in eval_args):
            eval_args.append('--decoder=trackingpose:0')

    if args.output is None:
        now = datetime.datetime.now().strftime('%y%m%d-%H%M%S')
        args.output = f'outputs/benchmark-{now}'

    return args, eval_args, dataset


def ablation_list(args, eval_args):
    ablations = [('', eval_args)]
    if args.ablation_1:
        ablations += [
            ('.greedy', eval_args + ['--greedy']),
            ('.no-reverse', eval_args + ['--no-reverse-match']),
            ('.greedy.no-reverse',
             eval_args + ['--greedy', '--no-reverse-match']),
        ]
    if args.ablation_2:
        ablations += [
            ('.nr.nms', eval_args + ['--ablation-cifseeds-no-rescore',
                                     '--ablation-cifseeds-nms',
                                     '--ablation-caf-no-rescore']),
        ]
    if args.ablation_3:
        base = [a for a in eval_args
                if not a.startswith(('--instance-threshold=', '--decoder='))]
        ablations += [
            ('.euclidean', base + ['--decoder=posesimilarity:0',
                                   '--posesimilarity-distance=euclidean']),
            ('.oks', base + ['--decoder=posesimilarity:0',
                             '--posesimilarity-distance=oks']),
            ('.oks-inflate2', base + ['--decoder=posesimilarity:0',
                                      '--posesimilarity-distance=oks',
                                      '--posesimilarity-oks-inflate=2.0']),
            ('.oks-inflate10', base + ['--decoder=posesimilarity:0',
                                       '--posesimilarity-distance=oks',
                                       '--posesimilarity-oks-inflate=10.0']),
        ]
    if args.ablation_4:
        ablations += [
            ('.w513', eval_args + ['--posetrack-eval-long-edge=513']),
            ('.w641', eval_args + ['--posetrack-eval-long-edge=641']),
            ('.w1201', eval_args + ['--posetrack-eval-long-edge=1201']),
        ]
    if args.ablation_5:
        ablations += [
            ('.recovery', eval_args + ['--trackingpose-track-recovery']),
        ]
    return ablations


def main(argv=None):
    args, eval_args, dataset = cli(argv)
    for suffix, ablation_args in ablation_list(args, eval_args):
        Benchmark(
            args.checkpoints, args.output + suffix,
            reference=(args.checkpoints[0] if len(args.checkpoints) == 1
                       else None),
            dataset=dataset or 'posetrack2018',
            eval_args=ablation_args,
        ).run().print_results()


if __name__ == '__main__':
    main()
