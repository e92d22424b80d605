"""Field drawing primitives (copy of ``openpifpaf_tpu/show/fields.py``)."""

import numpy as np

try:
    import matplotlib
    import matplotlib.patches
except ImportError:
    matplotlib = None


def white_screen(ax, alpha=0.9):
    ax.set_facecolor('white')
    ax.add_patch(matplotlib.patches.Rectangle(
        (-10000, -10000), 20000, 20000,
        alpha=alpha, facecolor='white', zorder=0.1))


def quiver(ax, vector_field, *, confidence_field=None, step=1, threshold=0.5,
           xy_scale=1.0, uv_is_offset=False, reg_uncertainty=None, **kwargs):
    """Draw a regression vector field."""
    x, y, u, v, c, r = [], [], [], [], [], []
    for j in range(0, vector_field.shape[1], step):
        for i in range(0, vector_field.shape[2], step):
            if confidence_field is not None \
               and confidence_field[j, i] < threshold:
                continue
            x.append(i * xy_scale)
            y.append(j * xy_scale)
            uu = vector_field[0, j, i] * xy_scale
            vv = vector_field[1, j, i] * xy_scale
            if not uv_is_offset:
                uu -= i * xy_scale
                vv -= j * xy_scale
            u.append(uu)
            v.append(vv)
            c.append(confidence_field[j, i]
                     if confidence_field is not None else 1.0)
            if reg_uncertainty is not None:
                r.append(reg_uncertainty[j, i] * xy_scale)

    x = np.array(x)
    y = np.array(y)
    u = np.nan_to_num(np.array(u))
    v = np.nan_to_num(np.array(v))
    c = np.array(c)

    for xx, yy, uu, vv, cc in zip(x, y, u, v, c):
        color = matplotlib.colormaps['viridis'](cc)
        ax.add_patch(matplotlib.patches.FancyArrow(
            xx, yy, uu, vv, width=0.5, zorder=10, head_width=2.0,
            facecolor=color, edgecolor='none'))

    return ax


def boxes(ax, sigma_field, *, regression_field=None, confidence_field=None,
          threshold=0.5, xy_scale=1.0, fill=False, **kwargs):
    """Draw scale fields as boxes around regression targets."""
    for j in range(sigma_field.shape[0]):
        for i in range(sigma_field.shape[1]):
            if confidence_field is not None \
               and confidence_field[j, i] < threshold:
                continue
            sigma = sigma_field[j, i] * xy_scale
            if not np.isfinite(sigma) or sigma <= 0:
                continue
            if regression_field is not None:
                cx = regression_field[0, j, i] * xy_scale
                cy = regression_field[1, j, i] * xy_scale
            else:
                cx, cy = i * xy_scale, j * xy_scale
            ax.add_patch(matplotlib.patches.Rectangle(
                (cx - sigma / 2, cy - sigma / 2), sigma, sigma,
                fill=fill, alpha=0.5, **kwargs))
    return ax


def circles(ax, scalar_field, *, confidence_field=None, threshold=0.5,
            xy_scale=1.0, fill=False, **kwargs):
    for j in range(scalar_field.shape[0]):
        for i in range(scalar_field.shape[1]):
            if confidence_field is not None \
               and confidence_field[j, i] < threshold:
                continue
            radius = scalar_field[j, i] * xy_scale
            if not np.isfinite(radius) or radius <= 0:
                continue
            ax.add_patch(matplotlib.patches.Circle(
                (i * xy_scale, j * xy_scale), radius,
                fill=fill, alpha=0.5, **kwargs))
    return ax
