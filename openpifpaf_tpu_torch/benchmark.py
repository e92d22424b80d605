"""Benchmark CLI (counterpart of ``openpifpaf_tpu/benchmark.py``; reference
``benchmark.py:36-283``): run the port's eval for several
checkpoints/configurations as subprocesses, collect the stats JSONs and
tabulate a markdown comparison. ``--device`` goes through to each eval.

Example:
    python -m openpifpaf_tpu_torch.benchmark --checkpoints model \
        --suite force-complete --n-images 100
"""

import argparse
import datetime
import json
import logging
import os
import subprocess
import sys

LOG = logging.getLogger(__name__)


#: named ablation suites (reference benchmark.py:215-250): each entry is a
#: (suffix, extra eval args) pair applied to every checkpoint
ABLATION_SUITES = {
    'iccv2019': [
        ('.singlescale-max', ['--connection-method=max']),
        ('.singlescale', ['--connection-method=blend']),
        ('.multiscale', ['--connection-method=blend',
                         '--long-edge=961', '--multi-scale']),
    ],
    'v012': [
        ('.greedy', ['--greedy']),
        ('.greedy.dense', ['--greedy', '--cocokp-with-dense',
                           '--dense-connections']),
        ('.dense', ['--cocokp-with-dense', '--dense-connections']),
        ('.dense.hierarchy', ['--cocokp-with-dense',
                              '--dense-connections=0.1']),
    ],
    'v012-1': [
        ('.greedy', ['--greedy']),
        ('.no-reverse', ['--no-reverse-match']),
        ('.greedy.no-reverse', ['--greedy', '--no-reverse-match']),
        ('.greedy.dense', ['--greedy', '--cocokp-with-dense',
                           '--dense-connections']),
        ('.dense', ['--cocokp-with-dense', '--dense-connections']),
    ],
    'v012-2': [
        ('.cifnr', ['--ablation-cifseeds-no-rescore']),
        ('.cifnr.nms', ['--ablation-cifseeds-no-rescore',
                        '--ablation-cifseeds-nms']),
        ('.cafnr', ['--ablation-caf-no-rescore']),
        ('.nr.nms', ['--ablation-cifseeds-no-rescore',
                     '--ablation-cifseeds-nms',
                     '--ablation-caf-no-rescore']),
    ],
    'v012-4': [
        ('.indkp', ['--ablation-independent-kp',
                    '--keypoint-threshold=0.2']),
    ],
    'force-complete': [
        ('.force-complete', ['--force-complete-pose']),
    ],
}

#: reference-compatible flag spellings -> suite names
SUITE_FLAG_ALIASES = {
    'iccv2019_ablation': 'iccv2019',
    'v012_ablation_1': 'v012-1',
    'v012_ablation_2': 'v012-2',
    'v012_ablation_4': 'v012-4',
}


class Benchmark:
    def __init__(self, checkpoints, output_folder, *, reference=None,
                 dataset='cocokp', eval_args=None):
        self.checkpoints = checkpoints
        self.output_folder = output_folder
        self.reference = reference
        self.dataset = dataset
        self.eval_args = eval_args or []

        os.makedirs(output_folder, exist_ok=True)

    def stats_file(self, checkpoint):
        name = checkpoint.replace('/', '-')
        return os.path.join(self.output_folder,
                            f'{name}.eval-{self.dataset}.stats.json')

    def run(self):
        for checkpoint in self.checkpoints:
            out_file = self.stats_file(checkpoint)
            if os.path.exists(out_file):
                LOG.info('skipping %s (exists)', out_file)
                continue
            cmd = [
                sys.executable, '-m', 'openpifpaf_tpu_torch.eval_cli',
                '--dataset', self.dataset,
                '--checkpoint', checkpoint,
                '--output', out_file.replace('.stats.json', ''),
            ] + self.eval_args
            LOG.info('running %s', ' '.join(cmd))
            subprocess.run(cmd, check=True)
        return self

    def print_results(self):
        rows = []
        reference_stats = None
        for checkpoint in self.checkpoints:
            out_file = self.stats_file(checkpoint)
            if not os.path.exists(out_file):
                continue
            with open(out_file) as f:
                stats = json.load(f)
            rows.append((checkpoint, stats))
            if checkpoint == self.reference:
                reference_stats = stats

        if not rows:
            print('no results')
            return

        labels = rows[0][1].get('text_labels', [])
        header = '| checkpoint | ' + ' | '.join(labels) + ' | t_total [ms] |'
        sep = '|' + '---|' * (len(labels) + 2)
        print(header)
        print(sep)
        for checkpoint, stats in rows:
            values = stats.get('stats', [])
            t_total = (stats.get('total_time', 0)
                       / max(1, stats.get('n_images', 1)) * 1000)
            cells = []
            for i, v in enumerate(values):
                cell = f'{v * 100:.1f}'
                if reference_stats and checkpoint != self.reference:
                    ref_v = reference_stats['stats'][i]
                    cell += f' ({(v - ref_v) * 100:+.1f})'
                cells.append(cell)
            print(f'| {checkpoint} | ' + ' | '.join(cells)
                  + f' | {t_total:.0f} |')


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='python3 -m openpifpaf_tpu_torch.benchmark')
    parser.add_argument('--checkpoints', nargs='+', required=True)
    parser.add_argument('--dataset', default='cocokp')
    parser.add_argument('--reference', default=None)
    parser.add_argument('-o', '--output', default=None)
    parser.add_argument('--n-images', type=int, default=None)
    parser.add_argument('--device', default=None,
                        help='torch device of each eval (its default: '
                             'cuda)')
    parser.add_argument('--suite', default=None,
                        choices=sorted(ABLATION_SUITES),
                        help='run a named ablation suite on top of the '
                             'default configuration')
    parser.add_argument('--iccv2019-ablation', default=False,
                        action='store_true')
    parser.add_argument('--v012-ablation-1', default=False,
                        action='store_true')
    parser.add_argument('--v012-ablation-2', default=False,
                        action='store_true')
    parser.add_argument('--v012-ablation-3', default=False,
                        action='store_true',
                        help='force-complete on/off comparison')
    parser.add_argument('--v012-ablation-4', default=False,
                        action='store_true')
    args, eval_args = parser.parse_known_args(argv)

    logging.basicConfig(level=logging.INFO)

    if args.output is None:
        now = datetime.datetime.now().strftime('%y%m%d-%H%M%S')
        args.output = f'outputs/benchmark-{now}'
    if args.n_images is not None:
        eval_args += ['--n-images', str(args.n_images)]
    if args.device is not None:
        eval_args += ['--device', args.device]

    ablations = [('', eval_args)]
    if args.suite:
        ablations += [(suffix, eval_args + extra)
                      for suffix, extra in ABLATION_SUITES[args.suite]]
    for flag, suite in SUITE_FLAG_ALIASES.items():
        if getattr(args, flag):
            ablations += [(suffix, eval_args + extra)
                          for suffix, extra in ABLATION_SUITES[suite]]
    if args.v012_ablation_3:
        # force-complete stripped from the arg list (reference
        # benchmark.py:255-262)
        eval_args_nofc = [a for a in eval_args
                          if not a.startswith('--force-complete')]
        ablations += [
            ('.nofc', eval_args_nofc),
            ('.nr.nms.nofc', eval_args_nofc + [
                '--ablation-cifseeds-no-rescore',
                '--ablation-cifseeds-nms',
                '--ablation-caf-no-rescore']),
        ]
    for suffix, ablation_args in ablations:
        Benchmark(args.checkpoints, args.output + suffix,
                  reference=args.reference,
                  dataset=args.dataset,
                  eval_args=ablation_args).run().print_results()


if __name__ == '__main__':
    main()
