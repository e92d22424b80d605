"""Show CLI options (copy of ``openpifpaf_tpu/show/cli.py``)."""

from .painters import KeypointPainter
from .animation_frame import AnimationFrame


def cli(parser):
    group = parser.add_argument_group('show')
    group.add_argument('--save-all', nargs='?', default=None, const='all-images/',
                       help='every plot is saved (optional to specify directory)')
    group.add_argument('--show', default=False, action='store_true',
                       help='show every plot, i.e., call matplotlib show()')
    group.add_argument('--image-width', default=None, type=float,
                       help='image width for matplotlib (in inches)')
    group.add_argument('--image-height', default=None, type=float,
                       help='image height for matplotlib (in inches)')
    group.add_argument('--image-dpi-factor', default=1.0, type=float,
                       help='increase dpi of output image by this factor')
    group.add_argument('--image-min-dpi', default=50.0, type=float,
                       help='minimum dpi of image output')
    group.add_argument('--show-file-extension', default='jpeg',
                       help='default file extension')
    group.add_argument('--textbox-alpha',
                       default=KeypointPainter.textbox_alpha, type=float,
                       help='transparency of annotation text box')
    group.add_argument('--text-color', default=KeypointPainter.text_color,
                       help='annotation text color')
    group.add_argument('--font-size', default=KeypointPainter.font_size,
                       type=int, help='annotation font size')
    group.add_argument('--monocolor-connections', default=False,
                       action='store_true',
                       help='use a single color per instance')
    group.add_argument('--line-width', default=None, type=int,
                       help='skeleton line width')
    group.add_argument('--skeleton-solid-threshold',
                       default=KeypointPainter.solid_threshold, type=float,
                       help='above this threshold, connections are drawn '
                            'with solid lines')
    group.add_argument('--white-overlay',
                       nargs='?', default=False, const=0.95, type=float,
                       help='increase contrast to annotations by making '
                            'image whiter')
    group.add_argument('--show-frontier-order', default=False,
                       action='store_true')
    group.add_argument('--show-kp-labels', default=False, action='store_true',
                       help='show keypoint labels')
    group.add_argument('--show-box', default=False, action='store_true')
    group.add_argument('--show-joint-scales', default=False,
                       action='store_true')
    group.add_argument('--show-joint-confidences', default=False,
                       action='store_true')
    group.add_argument('--show-decoding-order', default=False,
                       action='store_true')
    group.add_argument('--show-only-decoded-connections', default=False,
                       action='store_true')
    group.add_argument('--video-fps', default=AnimationFrame.video_fps,
                       type=float)
    group.add_argument('--video-dpi', default=AnimationFrame.video_dpi,
                       type=float)


def configure(args):
    from .canvas import CONFIG, SAVE_ALL
    SAVE_ALL['dir'] = args.save_all
    CONFIG['image_min_dpi'] = args.image_min_dpi
    CONFIG['out_file_extension'] = args.show_file_extension
    CONFIG['white_overlay'] = args.white_overlay
    KeypointPainter.textbox_alpha = args.textbox_alpha
    KeypointPainter.text_color = args.text_color
    KeypointPainter.font_size = args.font_size
    KeypointPainter.monocolor_connections = args.monocolor_connections
    KeypointPainter.line_width = args.line_width
    KeypointPainter.solid_threshold = args.skeleton_solid_threshold
    KeypointPainter.show_frontier_order = args.show_frontier_order
    KeypointPainter.show_box = args.show_box
    KeypointPainter.show_joint_scales = args.show_joint_scales
    KeypointPainter.show_joint_confidences = args.show_joint_confidences
    KeypointPainter.show_decoding_order = args.show_decoding_order
    KeypointPainter.show_only_decoded_connections = \
        args.show_only_decoded_connections
    AnimationFrame.video_fps = args.video_fps
    AnimationFrame.video_dpi = args.video_dpi

    if (args.show_decoding_order or args.show_frontier_order
            or args.show_only_decoded_connections):
        # these overlays need the decode to record each joint's
        # committing edge and step
        from ..decoder.cifcaf import CifCaf
        CifCaf.export_decoding_order = True
