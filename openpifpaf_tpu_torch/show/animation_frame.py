"""AnimationFrame: incremental video frame rendering / writing (copy of
``openpifpaf_tpu/show/animation_frame.py``)."""

import logging

import numpy as np

try:
    import matplotlib
    import matplotlib.animation
    import matplotlib.pyplot as plt
except ImportError:
    matplotlib = None
    plt = None

try:
    import pyvirtualcam
except ImportError:
    pyvirtualcam = None

LOG = logging.getLogger(__name__)


class VirtualCamWriter:
    """Stream rendered frames to a virtual webcam
    (reference ``show/animation_frame.py:25-51``; requires pyvirtualcam)."""

    def __init__(self, fps):
        self.fps = fps
        self.cam = None
        self.canvas = None
        self.fig = None

    def setup(self, fig, _, dpi=None):  # same interface as mpl writers
        from matplotlib.backends.backend_agg import FigureCanvasAgg
        self.canvas = FigureCanvasAgg(fig)
        self.fig = fig

    def grab_frame(self):
        self.canvas.draw()
        frame = np.asarray(self.canvas.buffer_rgba())
        if self.cam is None:
            if pyvirtualcam is None:
                raise ImportError(
                    'pyvirtualcam is required for --video-output virtualcam')
            self.cam = pyvirtualcam.Camera(
                frame.shape[1], frame.shape[0], self.fps)
            LOG.debug('virtual camera: %s', self.cam.device)
        else:
            self.cam.sleep_until_next_frame()
        self.cam.send(frame[:, :, :3])

    def finish(self):
        if self.cam is not None:
            self.cam.close()


class AnimationFrame:
    video_fps = 10
    video_dpi = 100

    def __init__(self, *, fig_width=8.0, fig_init_args=None,
                 video_output=None, second_visual=False):
        if plt is None:
            raise ImportError('matplotlib required for animation')

        self.fig_width = fig_width
        self.fig_init_args = fig_init_args or {}
        self.video_output = video_output
        self.second_visual = second_visual

        self.fig = None
        self.ax = None
        self.ax_second = None
        self._video_writer = None
        self._image_handle = None

    def frame_init(self, image):
        image = np.asarray(image)
        if 'figsize' not in self.fig_init_args:
            self.fig_init_args['figsize'] = (
                self.fig_width,
                self.fig_width * image.shape[0] / image.shape[1])

        self.fig = plt.figure(**self.fig_init_args)
        if self.second_visual:
            self.ax = self.fig.add_axes([0.0, 0.0, 0.5, 1.0])
            self.ax_second = self.fig.add_axes([0.5, 0.0, 0.5, 1.0])
            self.ax_second.set_axis_off()
        else:
            self.ax = self.fig.add_axes([0.0, 0.0, 1.0, 1.0])
        self.ax.set_axis_off()
        self.ax.set_xlim(0, image.shape[1])
        self.ax.set_ylim(image.shape[0], 0)

        if self.video_output == 'virtualcam':
            self._video_writer = VirtualCamWriter(self.video_fps)
            self._video_writer.setup(self.fig, self.video_output,
                                     dpi=self.video_dpi)
        elif self.video_output:
            self._video_writer = matplotlib.animation.writers['ffmpeg'](
                fps=self.video_fps)
            self._video_writer.setup(self.fig, self.video_output,
                                     dpi=self.video_dpi)
        return self.ax, self.ax_second

    def frame(self, image):
        if self.fig is None:
            self.frame_init(image)

        # clear dynamic artists
        for artist in list(self.ax.lines) + list(self.ax.patches) \
                + list(self.ax.texts):
            artist.remove()
        if self._image_handle is None:
            self._image_handle = self.ax.imshow(np.asarray(image))
        else:
            self._image_handle.set_data(np.asarray(image))
        return self.ax, self.ax_second

    def frame_done(self):
        if self._video_writer is not None:
            self._video_writer.grab_frame()
        else:
            plt.pause(0.01)

    def close(self):
        if self._video_writer is not None:
            self._video_writer.finish()
        if self.fig is not None:
            plt.close(self.fig)
