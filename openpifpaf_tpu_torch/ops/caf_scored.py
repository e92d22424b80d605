"""CafScored: association candidates rescored by CifHr at their target
joint (port of ``openpifpaf_tpu/ops/caf_scored.py``).

Every CAF cell above the score threshold yields a forward candidate
(source = joint1 end, target = joint2 end) and a backward candidate
(swapped), each rescored by the CifHr value at its target:
``c' = c * (cif_floor + (1 - cif_floor) * hr)``. Candidates stay dense as
(2E, C) directed-edge planes (first E forward, last E backward) with
confidence 0 for suppressed cells.
"""

import numpy as np
import torch

from .cifhr import cifhr_lookup, eval_cells
from .topk import top_k


def caf_scored(caf, hr, stride, skeleton, *, score_th=0.3, cif_floor=0.1,
               rescore=True, n_candidates=0, hr_cells=None, hr_shape=None,
               return_overflow=False):
    """Dense directed association candidates.

    caf: (E, 8, H, W) decoded field [logb, c, x1, y1, x2, y2, s1, s2];
    hr: (F, HS, WS) CifHr map, or None with ``hr_cells`` and ``hr_shape``
    set: the lazy CifHr (:func:`.cifhr.cif_hr_cells`) is then evaluated
    at the candidates' targets, (E, C, K) temporaries.
    ``rescore=False`` keeps the raw confidences
    (``--ablation-caf-no-rescore``). skeleton: (E, 2) 1-based joint
    indices. ``n_candidates`` > 0 compacts each edge plane to its top-K
    cells by raw confidence (overflow flags a plane with more than K cells
    above the threshold). Returns a dict of (2E, C) tensors c, sx, sy, tx,
    ty, ts.
    """
    n_edges, _, h, w = caf.shape
    hw = h * w

    c = caf[:, 1].reshape(n_edges, hw)
    payload = caf[:, 2:8].reshape(n_edges, 6, hw) * stride

    overflow = torch.zeros((), dtype=torch.bool, device=caf.device)
    if n_candidates and n_candidates < hw:
        k = int(n_candidates)
        c_masked = torch.where(c >= score_th, c, 0.0)
        overflow = torch.any(torch.sum(c_masked > 0.0, dim=-1) > k)
        c, idx = top_k(c_masked, k)
        payload = torch.gather(payload, 2,
                               idx[:, None, :].expand(n_edges, 6, k))
        base_mask = c > 0.0
    else:
        base_mask = c >= score_th
    x1, y1, x2, y2, s1, s2 = payload.unbind(1)

    if rescore:
        skeleton = torch.as_tensor(np.asarray(skeleton, dtype=np.int64),
                                   device=caf.device)
        # JAX's gather clamps an out-of-range index: a joint at or beyond
        # the CIF field count (TrackingPose's cross-frame edges name
        # joints of the second frame) reads the last field
        n_fields = (hr_cells['x'] if hr is None else hr).shape[0]
        j1 = torch.clamp_max(skeleton[:, 0] - 1, n_fields - 1)
        j2 = torch.clamp_max(skeleton[:, 1] - 1, n_fields - 1)
        if hr_cells is not None:
            hs, ws = hr_shape
            fwd_hr = eval_cells({k: a[j2] for k, a in hr_cells.items()},
                                x2, y2, hs=hs, ws=ws, default=0.0)
            bwd_hr = eval_cells({k: a[j1] for k, a in hr_cells.items()},
                                x1, y1, hs=hs, ws=ws, default=0.0)
        else:
            fwd_hr = cifhr_lookup(hr, j2[:, None].expand(c.shape), x2, y2,
                                  default=0.0)
            bwd_hr = cifhr_lookup(hr, j1[:, None].expand(c.shape), x1, y1,
                                  default=0.0)
        c_fwd = c * (cif_floor + (1.0 - cif_floor) * fwd_hr)
        c_bwd = c * (cif_floor + (1.0 - cif_floor) * bwd_hr)
    else:
        c_fwd = c
        c_bwd = c

    c_fwd = torch.where(base_mask & (c_fwd > score_th), c_fwd, 0.0)
    c_bwd = torch.where(base_mask & (c_bwd > score_th), c_bwd, 0.0)

    cands = {
        'c': torch.cat([c_fwd, c_bwd], dim=0),
        'sx': torch.cat([x1, x2], dim=0),
        'sy': torch.cat([y1, y2], dim=0),
        'tx': torch.cat([x2, x1], dim=0),
        'ty': torch.cat([y2, y1], dim=0),
        'ts': torch.cat([s2, s1], dim=0),
    }
    if return_overflow:
        return cands, overflow
    return cands
