"""Self-contained COCO-style evaluation (keypoints OKS and bbox IoU).

pycocotools is not available in this environment, so this module implements
the COCO evaluation protocol directly (same algorithm as COCOeval:
greedy per-threshold matching of score-sorted detections, ignore handling,
101-point interpolated AP). Reference protocol parameters from
``metric/coco.py:38-163``: max 20 detections/image for keypoints.
"""

import logging

import numpy as np

LOG = logging.getLogger(__name__)

IOU_THRESHOLDS = np.linspace(0.5, 0.95, 10)
RECALL_THRESHOLDS = np.linspace(0.0, 1.0, 101)

COCO_PERSON_SIGMAS = np.array([
    0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072,
    0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089])


def compute_oks(det_kps, gt_kps, gt_area, gt_bbox, sigmas):
    """OKS between one detection and one ground truth annotation."""
    sigmas = np.asarray(sigmas)
    variances = (sigmas * 2.0) ** 2
    xg = gt_kps[:, 0]
    yg = gt_kps[:, 1]
    vg = gt_kps[:, 2]
    k1 = np.count_nonzero(vg > 0)

    xd = det_kps[:, 0]
    yd = det_kps[:, 1]

    if k1 > 0:
        dx = xd - xg
        dy = yd - yg
    else:
        # gt without labeled keypoints: measure distance to the bbox
        x0, y0 = gt_bbox[0] - gt_bbox[2], gt_bbox[1] - gt_bbox[3]
        x1 = gt_bbox[0] + gt_bbox[2] * 2
        y1 = gt_bbox[1] + gt_bbox[3] * 2
        dx = np.maximum(0, np.maximum(x0 - xd, xd - x1))
        dy = np.maximum(0, np.maximum(y0 - yd, yd - y1))

    e = (dx ** 2 + dy ** 2) / variances / (gt_area + np.spacing(1)) / 2.0
    if k1 > 0:
        e = e[vg > 0]
    return np.sum(np.exp(-e)) / e.shape[0] if e.shape[0] > 0 else 0.0


def bbox_iou_xywh(det_box, gt_box, iscrowd=False):
    dx0, dy0, dw, dh = det_box
    gx0, gy0, gw, gh = gt_box
    ix = max(0.0, min(dx0 + dw, gx0 + gw) - max(dx0, gx0))
    iy = max(0.0, min(dy0 + dh, gy0 + gh) - max(dy0, gy0))
    inter = ix * iy
    if iscrowd:
        union = dw * dh
    else:
        union = dw * dh + gw * gh - inter
    return inter / union if union > 0 else 0.0


class EvalImage:
    """Matches for one (image, category) pair."""

    def __init__(self, dets, gts, iou_matrix, area_rng, max_det):
        # dets: list of dicts with 'score', 'area'; gts with 'ignore', 'area'
        n_t = len(IOU_THRESHOLDS)

        gt_ignore_base = np.array([
            1 if (g['ignore'] or g['area'] < area_rng[0] or g['area'] > area_rng[1])
            else 0
            for g in gts])
        # sort gts: non-ignored first (stable)
        gt_order = np.argsort(gt_ignore_base, kind='mergesort')
        gts = [gts[i] for i in gt_order]
        gt_ignore = gt_ignore_base[gt_order]

        det_order = np.argsort([-d['score'] for d in dets], kind='mergesort')
        det_order = det_order[:max_det]
        dets = [dets[i] for i in det_order]

        iou = iou_matrix[det_order][:, gt_order] if len(dets) and len(gts) \
            else np.zeros((len(dets), len(gts)))

        n_d = len(dets)
        n_g = len(gts)
        self.det_matched = np.zeros((n_t, n_d), dtype=np.int64)
        self.det_ignore = np.zeros((n_t, n_d), dtype=bool)
        self.gt_matched = np.zeros((n_t, n_g), dtype=np.int64)

        for t_i, t in enumerate(IOU_THRESHOLDS):
            for d_i, det in enumerate(dets):
                best_iou = min(t, 1 - 1e-10)
                best_g = -1
                for g_i in range(n_g):
                    if self.gt_matched[t_i, g_i] and not gts[g_i].get('iscrowd'):
                        continue
                    if best_g > -1 and not gt_ignore[best_g] and gt_ignore[g_i]:
                        break  # can't beat a real match with an ignore match
                    if iou[d_i, g_i] < best_iou:
                        continue
                    best_iou = iou[d_i, g_i]
                    best_g = g_i
                if best_g == -1:
                    continue
                self.det_ignore[t_i, d_i] = gt_ignore[best_g]
                self.det_matched[t_i, d_i] = 1
                self.gt_matched[t_i, best_g] = 1

            # unmatched dets outside the area range are ignored
            for d_i, det in enumerate(dets):
                if self.det_matched[t_i, d_i]:
                    continue
                if det['area'] < area_rng[0] or det['area'] > area_rng[1]:
                    self.det_ignore[t_i, d_i] = True

        self.det_scores = np.array([d['score'] for d in dets])
        self.gt_ignore = gt_ignore
        self.n_valid_gt = int(np.sum(gt_ignore == 0))


class CocoEval:
    """Accumulator over images producing COCO summary stats."""

    def __init__(self, *, iou_type='keypoints', sigmas=None, max_dets=20):
        self.iou_type = iou_type
        self.sigmas = sigmas if sigmas is not None else COCO_PERSON_SIGMAS
        self.max_dets = max_dets
        if iou_type == 'keypoints':
            self.area_rngs = [
                ('all', (0.0, 1e10)),
                ('medium', (32 ** 2, 96 ** 2)),
                ('large', (96 ** 2, 1e10)),
            ]
        else:
            self.area_rngs = [
                ('all', (0.0, 1e10)),
                ('small', (0.0, 32 ** 2)),
                ('medium', (32 ** 2, 96 ** 2)),
                ('large', (96 ** 2, 1e10)),
            ]
        # (category, image) -> (dets, gts)
        self.by_cat_image = {}

    def add_image(self, *, category_id, image_id, dets, gts):
        """dets: list of dicts with keys score, area, and either keypoints
        (n, 3) or bbox xywh. gts: dicts with keypoints/bbox, area, ignore,
        iscrowd."""
        self.by_cat_image[(category_id, image_id)] = (dets, gts)

    def _iou_matrix(self, dets, gts):
        if self.iou_type == 'keypoints':
            # COCO computes OKS for all det-gt pairs
            return np.array([
                [compute_oks(np.asarray(d['keypoints']),
                             np.asarray(g['keypoints']),
                             g['area'], np.asarray(g['bbox']), self.sigmas)
                 for g in gts]
                for d in dets
            ]) if dets and gts else np.zeros((len(dets), len(gts)))
        return np.array([
            [bbox_iou_xywh(d['bbox'], g['bbox'], g.get('iscrowd', False))
             for g in gts]
            for d in dets
        ]) if dets and gts else np.zeros((len(dets), len(gts)))

    def accumulate(self):
        n_t = len(IOU_THRESHOLDS)
        n_r = len(RECALL_THRESHOLDS)
        n_a = len(self.area_rngs)
        self.precision = -np.ones((n_t, n_r, n_a))
        self.recall = -np.ones((n_t, n_a))

        categories = sorted({c for c, _ in self.by_cat_image})
        precision_per_cat = -np.ones((n_t, n_r, n_a, max(len(categories), 1)))
        recall_per_cat = -np.ones((n_t, n_a, max(len(categories), 1)))

        for a_i, (_, area_rng) in enumerate(self.area_rngs):
            for c_i, cat in enumerate(categories):
                evals = []
                for (c, _), (dets, gts) in self.by_cat_image.items():
                    if c != cat:
                        continue
                    iou = self._iou_matrix(dets, gts)
                    evals.append(EvalImage(dets, gts, iou, area_rng,
                                           self.max_dets))
                if not evals:
                    continue

                det_scores = np.concatenate([e.det_scores for e in evals]) \
                    if evals else np.zeros(0)
                order = np.argsort(-det_scores, kind='mergesort')
                matched = np.concatenate(
                    [e.det_matched for e in evals], axis=1)[:, order]
                ignored = np.concatenate(
                    [e.det_ignore for e in evals], axis=1)[:, order]
                n_gt = sum(e.n_valid_gt for e in evals)
                if n_gt == 0:
                    continue

                tps = matched & ~ignored
                fps = (~matched.astype(bool)) & ~ignored
                tp_sum = np.cumsum(tps, axis=1).astype(float)
                fp_sum = np.cumsum(fps, axis=1).astype(float)

                for t_i in range(n_t):
                    tp = tp_sum[t_i]
                    fp = fp_sum[t_i]
                    rc = tp / n_gt
                    pr = tp / np.maximum(tp + fp, np.spacing(1))
                    recall_per_cat[t_i, a_i, c_i] = rc[-1] if len(rc) else 0.0

                    # make precision monotonically decreasing
                    pr = pr.tolist()
                    for i in range(len(pr) - 1, 0, -1):
                        if pr[i] > pr[i - 1]:
                            pr[i - 1] = pr[i]
                    inds = np.searchsorted(rc, RECALL_THRESHOLDS, side='left')
                    q = np.zeros(n_r)
                    for r_i, p_i in enumerate(inds):
                        if p_i < len(pr):
                            q[r_i] = pr[p_i]
                    precision_per_cat[t_i, :, a_i, c_i] = q

        # average over categories with valid entries
        self.precision = precision_per_cat
        self.recall = recall_per_cat
        return self

    def _summarize(self, ap=1, iou_thr=None, area='all', max_dets=None):
        a_i = [i for i, (name, _) in enumerate(self.area_rngs) if name == area]
        if ap:
            s = self.precision
            if iou_thr is not None:
                t_i = np.where(np.isclose(IOU_THRESHOLDS, iou_thr))[0]
                s = s[t_i]
            s = s[:, :, a_i]
        else:
            s = self.recall
            if iou_thr is not None:
                t_i = np.where(np.isclose(IOU_THRESHOLDS, iou_thr))[0]
                s = s[t_i]
            s = s[:, a_i]
        valid = s > -1
        if not np.any(valid):
            return -1.0
        return float(np.mean(s[valid]))

    def stats(self):
        """COCO keypoint summary: AP, AP.5, AP.75, APM, APL, AR, AR.5,
        AR.75, ARM, ARL."""
        self.accumulate()
        if self.iou_type == 'keypoints':
            return [
                self._summarize(1),
                self._summarize(1, iou_thr=0.5),
                self._summarize(1, iou_thr=0.75),
                self._summarize(1, area='medium'),
                self._summarize(1, area='large'),
                self._summarize(0),
                self._summarize(0, iou_thr=0.5),
                self._summarize(0, iou_thr=0.75),
                self._summarize(0, area='medium'),
                self._summarize(0, area='large'),
            ]
        return [
            self._summarize(1),
            self._summarize(1, iou_thr=0.5),
            self._summarize(1, iou_thr=0.75),
            self._summarize(1, area='small'),
            self._summarize(1, area='medium'),
            self._summarize(1, area='large'),
            self._summarize(0),
            self._summarize(0, area='small'),
            self._summarize(0, area='medium'),
            self._summarize(0, area='large'),
        ]
