"""Video CLI of the port (counterpart of ``openpifpaf_tpu/video.py``):
webcam, video file or a comma-separated list of still images -> poses,
tracked when the checkpoint is a tracking model's.

Example:
    python -m openpifpaf_tpu_torch.video --source a.jpg,b.jpg \\
        --checkpoint model --json-output out.json

``--json-output`` writes one JSON line per frame, as the JAX package does.
Without ``--device cpu`` it runs on the first CUDA device and raises where
there is none. ``--video-output`` draws each frame's annotations into a
video with matplotlib's ``ffmpeg`` writer, or, where matplotlib has no
``ffmpeg``, into one JPEG per frame named ``<video-output>.<frame>.jpg``;
``--show`` draws them on screen.
"""

import argparse
import json
import logging
import os

import numpy as np

from . import __version__, decoder, logger
from .predictor import BACKBONE_ENGINES, Predictor
from .stream import Stream

LOG = logging.getLogger(__name__)


def cli(args=None):
    parser = argparse.ArgumentParser(
        prog='python3 -m openpifpaf_tpu_torch.video',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument('--version', action='version',
                        version=f'OpenPifPaf-TPU (PyTorch) {__version__}')
    parser.add_argument('--source', default='0',
                        help='OpenCV source url or device id, or a '
                             'comma-separated list of still images')
    parser.add_argument('--checkpoint', default=None,
                        help='checkpoint of the port (path without '
                             '.json/.pt), a reference .pkl or a published '
                             'name; default: random-init shufflenetv2k16 '
                             'with the cocokp heads')
    parser.add_argument('--long-edge', default=None, type=int)
    parser.add_argument('--video-output', default=None, nargs='?', const=True,
                        help='video output file (default: the source name '
                             'with .pifpaf.mp4), or "virtualcam"')
    parser.add_argument('--json-output', default=None, nargs='?', const=True)
    parser.add_argument('--scale', default=1.0, type=float)
    parser.add_argument('--start-frame', default=None, type=int)
    parser.add_argument('--start-msec', default=None, type=float)
    parser.add_argument('--max-frames', default=None, type=int)
    parser.add_argument('--crop', nargs=4, type=int, default=None)
    parser.add_argument('--rotate', default=None, type=int)
    parser.add_argument('--horizontal-flip', default=False,
                        action='store_true',
                        help='mirror the input video')
    parser.add_argument('--separate-debug-ax', default=False,
                        action='store_true',
                        help='debug overlays on a separate axis next to '
                             'the annotated frame (with --video-output)')
    parser.add_argument('--show', default=False, action='store_true',
                        help='show every frame with matplotlib')
    parser.add_argument('--device', default='cuda',
                        help='torch device of the forward and the decode; '
                             '"cpu" runs on the CPU')
    parser.add_argument('--bf16', default=False, action='store_true',
                        help='run the backbone in bfloat16')
    parser.add_argument('--backbone-engine', default='auto',
                        choices=BACKBONE_ENGINES,
                        help='serving backbone engine (see predict)')
    parser.add_argument('--precise-rescaling', dest='fast_rescaling',
                        default=True, action='store_false',
                        help='accepted and ignored: a no-op, as in the '
                             'JAX package, whose rescale never reads it')
    parser.add_argument('--debug', default=False, action='store_true')
    logger.cli(parser)
    decoder.cli(parser)
    decoder.TrackBase.cli(parser)

    args = parser.parse_args(args)
    logger.configure(args, LOG)
    decoder.configure(args)
    decoder.TrackBase.configure(args)

    # output files
    if args.video_output is True:
        args.video_output = args.source + '.pifpaf.mp4'
        assert not os.path.exists(args.video_output)
    if args.json_output is True:
        args.json_output = args.source + '.pifpaf.json'
        assert not os.path.exists(args.json_output)
    return args


def main(args=None):
    args = cli(args)

    predictor = Predictor(checkpoint=args.checkpoint, device=args.device,
                          backbone_engine=args.backbone_engine,
                          bf16=args.bf16)
    predictor.long_edge = args.long_edge
    # frame at a time, as JAX's video: the current frame's poses, not one
    # frame late
    predictor.pipeline_decode = False
    predictor.preprocess = predictor._build_preprocess()

    stream = Stream(
        args.source,
        preprocess=predictor.preprocess,
        scale=args.scale,
        start_frame=args.start_frame,
        start_msec=args.start_msec,
        crop=args.crop,
        rotate=args.rotate,
        horizontal_flip=args.horizontal_flip,
        max_frames=args.max_frames,
        with_raw_image=True,
    )

    json_f = open(args.json_output, 'w') if args.json_output else None

    # with a usable writer (virtualcam or ffmpeg), render through
    # AnimationFrame; without ffmpeg, fall back to per-frame jpgs next to
    # the requested output name
    animation = None
    painter = None
    use_animation = False
    if args.video_output == 'virtualcam' or args.show:
        use_animation = True
    elif args.video_output:
        import matplotlib.animation as manimation
        use_animation = 'ffmpeg' in manimation.writers.list()
        if not use_animation:
            LOG.warning('ffmpeg not available: writing per-frame jpgs '
                        'instead of %s', args.video_output)

    try:
        for raw_image, processed, anns, meta in stream:
            batch = ([raw_image], np.asarray(processed)[None], [anns], [meta])
            for pred, _, frame_meta in predictor._run_batch(batch):
                if json_f is not None:
                    json_f.write(json.dumps({
                        'frame': frame_meta.get('frame_i'),
                        'predictions': [ann.json_data() for ann in pred],
                    }) + '\n')

                if args.video_output or args.show:
                    if not args.show:
                        import matplotlib
                        matplotlib.use('Agg')
                    from . import show, visualizer
                    if painter is None:
                        painter = show.AnnotationPainter()
                    if use_animation:
                        if animation is None:
                            animation = show.AnimationFrame(
                                video_output=args.video_output,
                                second_visual=args.separate_debug_ax)
                            ax, ax_second = animation.frame_init(raw_image)
                            visualizer.Base.common_ax = (
                                ax_second if args.separate_debug_ax else ax)
                        ax, _ = animation.frame(raw_image)
                        painter.annotations(ax, pred)
                        animation.frame_done()
                    else:
                        out_name = (args.video_output
                                    + f'.{frame_meta.get("frame_i"):06d}'
                                      '.jpg')
                        with show.image_canvas(raw_image, out_name,
                                               show=False) as ax:
                            painter.annotations(ax, pred)

                LOG.info('frame %d: %d annotations',
                         frame_meta.get('frame_i', -1), len(pred))
    finally:
        if json_f is not None:
            json_f.close()
        if animation is not None:
            animation.close()


if __name__ == '__main__':
    main()
