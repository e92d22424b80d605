"""Canvas helpers (copy of ``openpifpaf_tpu/show/canvas.py``). Matplotlib is
optional."""

from contextlib import contextmanager

import numpy as np

try:
    import matplotlib
    import matplotlib.pyplot as plt
except ImportError:
    matplotlib = None
    plt = None


#: --save-all state: when 'dir' is set, every canvas without an explicit
#: fig_file is saved there with a running index. A dict (not a bare module
#: global) so `from .canvas import SAVE_ALL` keeps working even though
#: show/__init__ re-exports the `canvas` function under the same name as
#: this module.
SAVE_ALL = {'dir': None, 'count': 0}

#: canvas rendering config (reference show/canvas.py Canvas statics),
#: mutated by show.cli configure
CONFIG = {
    'out_file_extension': 'jpeg',  # --show-file-extension
    'image_min_dpi': 50.0,         # --image-min-dpi
    'white_overlay': False,        # --white-overlay
}


def _auto_fig_file():
    if SAVE_ALL['dir'] is None:
        return None
    import os
    os.makedirs(SAVE_ALL['dir'], exist_ok=True)
    SAVE_ALL['count'] += 1
    return os.path.join(
        SAVE_ALL['dir'],
        f"{SAVE_ALL['count']:04d}.{CONFIG['out_file_extension']}")


def white_screen(ax, alpha=0.9):
    ax.set_axis_off()
    ax.add_patch(plt.Rectangle(
        (0, 0), 1, 1, transform=ax.transAxes, alpha=alpha,
        facecolor='white'))


@contextmanager
def canvas(fig_file=None, show=True, dpi=100, nomargin=False, **kwargs):
    if plt is None:
        raise ImportError('matplotlib is not installed')
    if fig_file is None:
        fig_file = _auto_fig_file()
    if nomargin:
        fig = plt.figure(**kwargs)
        ax = plt.Axes(fig, [0.0, 0.0, 1.0, 1.0])
        ax.set_axis_off()
        fig.add_axes(ax)
    else:
        fig, ax = plt.subplots(**kwargs)
    yield ax
    fig.set_tight_layout(not nomargin)
    if fig_file:
        fig.savefig(fig_file, dpi=dpi)
    if show:
        plt.show()
    plt.close(fig)


@contextmanager
def image_canvas(image, fig_file=None, show=True, dpi_factor=1.0,
                 fig_width=10.0, **kwargs):
    if plt is None:
        raise ImportError('matplotlib is not installed')
    if fig_file is None:
        fig_file = _auto_fig_file()
    image = np.asarray(image)
    if 'figsize' not in kwargs:
        kwargs['figsize'] = (fig_width,
                             fig_width * image.shape[0] / image.shape[1])
    fig = plt.figure(**kwargs)
    ax = plt.Axes(fig, [0.0, 0.0, 1.0, 1.0])
    ax.set_axis_off()
    ax.set_xlim(0, image.shape[1])
    ax.set_ylim(image.shape[0], 0)
    fig.add_axes(ax)
    ax.imshow(image)
    if CONFIG['white_overlay']:
        white_screen(ax, CONFIG['white_overlay'])
    yield ax
    if fig_file:
        dpi = max(CONFIG['image_min_dpi'],
                  image.shape[1] / kwargs['figsize'][0] * dpi_factor)
        fig.savefig(fig_file, dpi=dpi)
    if show:
        plt.show()
    plt.close(fig)


@contextmanager
def annotation_canvas(ann, *, filename=None, margin=0.5,
                      fig_w=None, fig_h=5.0, **kwargs):
    """Canvas framed around one annotation's bounding box
    (reference show/canvas.py Canvas.annotation)."""
    bbox = ann.bbox()
    xlim = bbox[0] - margin, bbox[0] + bbox[2] + margin
    ylim = bbox[1] - margin, bbox[1] + bbox[3] + margin
    if fig_w is None:
        fig_w = fig_h / (ylim[1] - ylim[0]) * (xlim[1] - xlim[0])

    with canvas(filename, figsize=(fig_w, fig_h), nomargin=True,
                **kwargs) as ax:
        ax.set_axis_off()
        ax.set_xlim(*xlim)
        ax.set_ylim(ylim[1], ylim[0])
        yield ax


class Canvas:
    """Class-style canvas API (reference show/canvas.py:18-171)."""

    blank = staticmethod(canvas)
    image = staticmethod(image_canvas)
    annotation = staticmethod(annotation_canvas)
