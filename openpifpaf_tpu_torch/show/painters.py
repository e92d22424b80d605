"""Annotation painters (copy of ``openpifpaf_tpu/show/painters.py``).

Draw keypoint skeletons, detection boxes and crowd regions on a matplotlib
axis, including the debug overlays (``--show-box``, ``--show-joint-scales``,
``--show-joint-confidences``, ``--show-decoding-order``,
``--show-frontier-order``, ``--show-only-decoded-connections``).
Matplotlib is optional — painters raise only when actually used.
"""

import numpy as np

try:
    import matplotlib
    import matplotlib.animation
    import matplotlib.collections
    import matplotlib.patches
except ImportError:
    matplotlib = None

CMAP_ORANGES_NAN = None
if matplotlib is not None:
    CMAP_ORANGES_NAN = matplotlib.colormaps['Oranges']


def _tab20(i):
    return matplotlib.colormaps['tab20']((i % 20 + 0.05) / 20)


class KeypointPainter:
    show_box = False
    show_joint_confidences = False
    show_joint_scales = False
    show_decoding_order = False
    show_frontier_order = False
    show_only_decoded_connections = False
    textbox_alpha = 0.5
    text_color = 'white'
    monocolor_connections = False
    line_width = None
    marker_size = None
    solid_threshold = 0.5
    font_size = 8

    def __init__(self, *, xy_scale=1.0, highlight=None, highlight_invisible=False):
        self.xy_scale = xy_scale
        self.highlight = highlight
        self.highlight_invisible = highlight_invisible

        # defaults depend on monocolor (reference painters.py:167-174)
        if self.line_width is None:
            self.line_width = 2 if self.monocolor_connections else 6
        if self.marker_size is None:
            if self.monocolor_connections:
                self.marker_size = max(self.line_width + 1,
                                       int(self.line_width * 3.0))
            else:
                self.marker_size = max(1, int(self.line_width * 0.5))

    def _draw_skeleton(self, ax, x, y, v, *, skeleton, skeleton_mask=None,
                       color=None, alpha=1.0, linewidth=None, linestyle=None):
        if not np.any(v > 0):
            return
        if skeleton_mask is None:
            skeleton_mask = [True] * len(skeleton)

        lines, line_colors, line_styles = [], [], []
        for ci, ((j1i, j2i), mask) in enumerate(
                zip(np.asarray(skeleton) - 1, skeleton_mask)):
            if not mask:
                continue
            c = color if self.monocolor_connections else _tab20(ci)
            if v[j1i] > 0 and v[j2i] > 0:
                lines.append([(x[j1i], y[j1i]), (x[j2i], y[j2i])])
                line_colors.append(c)
                line_styles.append(
                    'solid' if (v[j1i] > self.solid_threshold
                                and v[j2i] > self.solid_threshold)
                    else 'dashed')
        ax.add_collection(matplotlib.collections.LineCollection(
            lines, colors=line_colors,
            linewidths=linewidth if linewidth is not None else self.line_width,
            linestyles=linestyle if linestyle is not None else line_styles,
            capstyle='round', alpha=alpha))

        ax.scatter(
            x[v > 0], y[v > 0], s=self.marker_size ** 2, marker='.',
            color=color if self.monocolor_connections else 'white',
            edgecolor='k' if self.highlight_invisible else None,
            zorder=2, alpha=alpha)

        if self.highlight is not None:
            highlight_v = np.zeros_like(v)
            highlight_v[self.highlight] = 1
            highlight_v = np.logical_and(v > 0, highlight_v > 0)
            ax.scatter(
                x[highlight_v], y[highlight_v],
                s=(self.marker_size * 3) ** 2, marker='.',
                color=color if self.monocolor_connections else 'white',
                edgecolor='k' if self.highlight_invisible else None,
                zorder=2, alpha=alpha)

    @staticmethod
    def _draw_box(ax, x, y, w, h, color, score=None, linewidth=1):
        """Bounding box with optional score label (--show-box)."""
        if w < 5.0:
            x -= 2.0
            w += 4.0
        if h < 5.0:
            y -= 2.0
            h += 4.0
        ax.add_patch(matplotlib.patches.Rectangle(
            (x, y), w, h, fill=False, color=color, linewidth=linewidth))
        if score:
            ax.text(x, y - linewidth, f'{score:.4f}', fontsize=8,
                    color=color)

    @classmethod
    def _draw_text(cls, ax, x, y, v, text, color, *, subtext=None, alpha=1.0):
        """Label anchored at the topmost visible joint; when the second
        joint is within 10px vertically, blend the anchor between them so
        labels of stacked poses do not collide
        (reference painters.py:277-316)."""
        if cls.font_size == 0 or not np.any(v > 0):
            return
        xv, yv = x[v > 0], y[v > 0]
        order = np.argsort(yv)
        if len(yv) >= 2 and yv[order[1]] < yv[order[0]] + 10:
            f0 = 0.5 + 0.5 * (yv[order[1]] - yv[order[0]]) / 10.0
            coord_x = f0 * xv[order[0]] + (1.0 - f0) * xv[order[1]]
            coord_y = f0 * yv[order[0]] + (1.0 - f0) * yv[order[1]]
        else:
            coord_x, coord_y = xv[order[0]], yv[order[0]]

        bbox = {'facecolor': color, 'alpha': alpha * cls.textbox_alpha,
                'linewidth': 0}
        ax.annotate(text, (coord_x, coord_y), fontsize=cls.font_size,
                    xytext=(5.0, 5.0), textcoords='offset points',
                    color=cls.text_color, bbox=bbox, alpha=alpha)
        if subtext is not None:
            ax.annotate(subtext, (coord_x, coord_y),
                        fontsize=cls.font_size * 5 // 8,
                        xytext=(5.0, 21.0), textcoords='offset points',
                        color=cls.text_color, bbox=bbox, alpha=alpha)

    @staticmethod
    def _draw_scales(ax, xs, ys, vs, color, scales, alpha=1.0):
        """Per-joint scale squares (--show-joint-scales)."""
        for x, y, v, scale in zip(xs, ys, vs, scales):
            if v == 0.0:
                continue
            ax.add_patch(matplotlib.patches.Rectangle(
                (x - scale / 2, y - scale / 2), scale, scale,
                fill=False, color=color, alpha=alpha))

    @classmethod
    def _draw_joint_confidences(cls, ax, xs, ys, vs, color):
        """Per-joint confidence text (--show-joint-confidences)."""
        for x, y, v in zip(xs, ys, vs):
            if v == 0.0:
                continue
            ax.annotate(f'{v:.0%}', (x, y), fontsize=6,
                        xytext=(0.0, 0.0), textcoords='offset points',
                        verticalalignment='top', color=cls.text_color,
                        bbox={'facecolor': color, 'alpha': 0.2,
                              'linewidth': 0, 'pad': 0.0})

    @staticmethod
    def _draw_decoding_order(ax, decoding_order):
        """Numbered step arrows (--show-decoding-order); entries are
        (source_joint, target_joint, source_xyv, target_xyv)."""
        for step_i, (jsi, jti, jsxyv, jtxyv) in enumerate(decoding_order):
            ax.plot([jsxyv[0], jtxyv[0]], [jsxyv[1], jtxyv[1]], '--',
                    color='black')
            ax.text(0.5 * (jsxyv[0] + jtxyv[0]),
                    0.5 * (jsxyv[1] + jtxyv[1]),
                    f'{step_i}: {jsi} -> {jti}', fontsize=8, color='white',
                    bbox={'facecolor': 'black', 'alpha': 0.5,
                          'linewidth': 0})

    def annotation(self, ax, ann, *, color=None, text=None, subtext=None,
                   alpha=1.0):
        if matplotlib is None:
            raise ImportError('matplotlib is not installed')
        if color is None:
            color = 'blue'

        text_is_score = False
        if text is None and getattr(ann, 'id_', None):
            text = f'{ann.id_}'
        if text is None and ann.score:
            # GT annotations carry fixed_score = '' -> no score text
            # (reference painters.py:350-357)
            text = f'{ann.score:.0%}'
            text_is_score = True
        if subtext is None and not text_is_score and ann.score:
            subtext = f'{ann.score:.0%}'

        x = ann.data[:, 0] * self.xy_scale
        y = ann.data[:, 1] * self.xy_scale
        v = ann.data[:, 2]

        if self.show_frontier_order:
            # dotted black overlay of the skeleton edges still on the
            # decoder frontier when growth stopped
            frontier = set((s, e) for s, e in ann.frontier_order)
            frontier_skeleton = [
                se for se in ann.skeleton
                if (se[0] - 1, se[1] - 1) in frontier
                or (se[1] - 1, se[0] - 1) in frontier]
            if frontier_skeleton:
                self._draw_skeleton(ax, x, y, v, color='black',
                                    skeleton=frontier_skeleton,
                                    linestyle='dotted', linewidth=1)

        skeleton_mask = None
        if self.show_only_decoded_connections:
            decoded = set((jsi, jti) for jsi, jti, _, __ in
                          ann.decoding_order)
            skeleton_mask = [
                (s - 1, e - 1) in decoded or (e - 1, s - 1) in decoded
                for s, e in ann.skeleton]

        self._draw_skeleton(ax, x, y, v, skeleton=ann.skeleton,
                            skeleton_mask=skeleton_mask, color=color,
                            alpha=alpha)

        if self.show_joint_scales and ann.joint_scales is not None:
            self._draw_scales(ax, x, y, v, color,
                              ann.joint_scales * self.xy_scale, alpha=alpha)

        if self.show_joint_confidences:
            self._draw_joint_confidences(ax, x, y, v, color)

        if self.show_box:
            bx, by, bw, bh = [c * self.xy_scale for c in ann.bbox()]
            self._draw_box(ax, bx, by, bw, bh, color, ann.score)

        if text is not None:
            self._draw_text(ax, x, y, v, text, color, subtext=subtext,
                            alpha=alpha)

        if self.show_decoding_order and getattr(ann, 'decoding_order', None):
            self._draw_decoding_order(ax, ann.decoding_order)

    def annotations(self, ax, anns, *, colors=None, texts=None, subtexts=None):
        for i, ann in enumerate(anns):
            color = colors[i] if colors is not None else i
            if isinstance(color, (int, np.integer)):
                color = _tab20(color)
            text = texts[i] if texts is not None else None
            subtext = subtexts[i] if subtexts is not None else None
            self.annotation(ax, ann, color=color, text=text, subtext=subtext)

    def keypoints(self, ax, keypoint_sets, *, skeleton, scores=None,
                  color=None, colors=None, texts=None):
        """Paint raw (N, K, 3) keypoint arrays without Annotation objects
        (reference painters.py:234-260)."""
        if keypoint_sets is None:
            return
        if color is None and colors is None:
            colors = range(len(keypoint_sets))
        for i, kps in enumerate(np.asarray(keypoint_sets)):
            x = kps[:, 0] * self.xy_scale
            y = kps[:, 1] * self.xy_scale
            v = kps[:, 2]
            if colors is not None:
                color = colors[i]
            if isinstance(color, (int, np.integer)):
                color = _tab20(color)
            self._draw_skeleton(ax, x, y, v, skeleton=skeleton, color=color)
            if self.show_box:
                m = v > 0
                if np.any(m):
                    bx, by = np.min(x[m]), np.min(y[m])
                    self._draw_box(ax, bx, by, np.max(x[m]) - bx,
                                   np.max(y[m]) - by, color,
                                   scores[i] if scores is not None else None)
            if texts is not None:
                self._draw_text(ax, x, y, v, texts[i], color)


class DetectionPainter:
    def __init__(self, *, xy_scale=1.0):
        self.xy_scale = xy_scale

    def annotation(self, ax, ann, *, color=None, text=None, subtext=None):
        if matplotlib is None:
            raise ImportError('matplotlib is not installed')
        if color is None:
            color = 'blue'

        if text is None:
            text = ann.category
            if getattr(ann, 'id_', None):
                text += f' ({ann.id_})'
        if subtext is None and ann.score:
            subtext = f'{ann.score:.0%}'

        x, y, w, h = ann.bbox * self.xy_scale
        if w < 5.0:
            x -= 2.0
            w += 4.0
        if h < 5.0:
            y -= 2.0
            h += 4.0

        ax.add_patch(matplotlib.patches.Rectangle(
            (x, y), w, h, fill=False, color=color, linewidth=1.0))

        ax.annotate(text, (x, y), fontsize=8, xytext=(5.0, 5.0),
                    textcoords='offset points', color='white',
                    bbox={'facecolor': color, 'alpha': 0.5, 'linewidth': 0})
        if subtext is not None:
            ax.annotate(subtext, (x, y), fontsize=5, xytext=(5.0, 21.0),
                        textcoords='offset points', color='white',
                        bbox={'facecolor': color, 'alpha': 0.5,
                              'linewidth': 0})

    def annotations(self, ax, anns, *, colors=None, texts=None, subtexts=None):
        for i, ann in enumerate(anns):
            color = colors[i] if colors is not None else i
            if isinstance(color, (int, np.integer)):
                color = _tab20(color)
            text = texts[i] if texts is not None else None
            subtext = subtexts[i] if subtexts is not None else None
            self.annotation(ax, ann, color=color, text=text, subtext=subtext)


class CrowdPainter:
    def __init__(self, *, alpha=0.5, color='orange', xy_scale=1.0):
        self.alpha = alpha
        self.color = color
        self.xy_scale = xy_scale

    @staticmethod
    def draw_polygon(ax, outlines, *, alpha=0.5, color='orange'):
        """Filled polygon outlines for crowd regions
        (reference painters.py:73-83)."""
        patches = []
        for outline in outlines:
            assert outline.shape[1] == 2
            patches.append(matplotlib.patches.Polygon(
                outline[:, :2], facecolor=color, edgecolor=color,
                alpha=alpha))
        ax.add_collection(matplotlib.collections.PatchCollection(
            patches, match_original=True))

    def annotation(self, ax, ann, *, color=None, text=None, subtext=None):
        if matplotlib is None:
            raise ImportError('matplotlib is not installed')
        if color is None:
            color = self.color

        if text is None:
            text = f'{getattr(ann, "category", "crowd")} (crowd)'

        x, y, w, h = ann.bbox * self.xy_scale
        ax.add_patch(matplotlib.patches.Rectangle(
            (x, y), w, h, fill=True, color=color, alpha=self.alpha,
            linestyle='dotted'))
        ax.annotate(text, (x, y), fontsize=8, xytext=(5.0, 5.0),
                    textcoords='offset points', color='white',
                    bbox={'facecolor': color, 'alpha': 0.5, 'linewidth': 0})

    def annotations(self, ax, anns, *, colors=None, texts=None, subtexts=None):
        for i, ann in enumerate(anns):
            color = colors[i] if colors is not None else self.color
            if isinstance(color, (int, np.integer)):
                color = _tab20(color)
            text = texts[i] if texts is not None else None
            self.annotation(ax, ann, color=color, text=text)


class AnnotationPainter:
    def __init__(self, *, xy_scale=1.0, painters=None):
        from . import PAINTERS  # late import: registry may be extended
        self.painters = {
            name: painter(xy_scale=xy_scale)
            for name, painter in PAINTERS.items()
        }
        if painters:
            self.painters.update(painters)

    def annotations(self, ax, annotations, *, colors=None, color=None,
                    texts=None, subtexts=None):
        by_classname = {}
        for ann_i, ann in enumerate(annotations):
            by_classname.setdefault(ann.__class__.__name__, []).append((ann_i, ann))

        for classname, anns in by_classname.items():
            if classname not in self.painters:
                continue
            indices = [i for i, _ in anns]
            this_colors = [colors[i] for i in indices] if colors is not None \
                else ([color] * len(anns) if color is not None else indices)
            this_texts = [texts[i] for i in indices] if texts is not None else None
            this_subtexts = [subtexts[i] for i in indices] \
                if subtexts is not None else None
            self.painters[classname].annotations(
                ax, [a for _, a in anns], colors=this_colors,
                texts=this_texts, subtexts=this_subtexts)
