"""Composite-field losses in PyTorch (port of
``openpifpaf_tpu/training/losses.py``).

Every component is computed densely and reduced with mask-weighted sums,
as in the JAX package; ``jax.lax.stop_gradient`` is ``.detach()``.

Component semantics:
- ``Bce`` — focal BCE (alpha=0.5, gamma=1) via the smooth-L1-on-constructed-
  target trick, background clamp at -15, soft clamp at 5, sigma-uncertainty
  weighting of foreground by the logb channel.
- ``Regression`` — L2 over (dx, dy, bmin) scale-normalized by
  ``0.5 * t_scale`` with Laplace log-b uncertainty.
- ``Scale`` — relative L1 on softplus(x).

The guards against the untaken branch's NaN gradient (the pre-clamped
``log1p`` argument, ``1e-12`` under each ``sqrt``) are kept: autograd,
like JAX, multiplies a zero by the untaken branch's infinite derivative.
"""

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from .. import headmeta
from ..parallel.mesh import rank_mean


@dataclasses.dataclass
class ComponentConfig:
    """CLI-configurable loss component constants."""
    focal_alpha: float = 0.5
    focal_gamma: float = 1.0
    bce_soft_clamp: float = 5.0
    bce_background_clamp: float = -15.0
    regression_soft_clamp: float = 5.0
    b_scale: float = 1.0
    scale_log: bool = False
    scale_soft_clamp: float = 5.0


#: set by Factory.configure; read by CompositeLoss when it is called
COMPONENT_CONFIG = ComponentConfig()


def soft_clamp(x, max_value=5.0):
    """Log-damped clamp. The log1p argument is pre-clamped to the branch's
    domain: d/dx log1p(x - max) has a pole at x = max - 1, and
    ``torch.where`` does not keep the untaken branch's infinite
    derivative out of the backward pass (0 * inf = NaN)."""
    overflow = torch.clamp(x, min=max_value) - max_value
    return torch.where(x > max_value, max_value + torch.log1p(overflow), x)


def smooth_l1(d):
    ad = torch.abs(d)
    return torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5)


def _logs2(x_logb_channel):
    return 3.0 * torch.tanh(x_logb_channel / 3.0)


def _nan_to(t, mask, value):
    return torch.where(mask, t, torch.full_like(t, value))


def bce_loss(x_all, t_all, *, xi, ti, weights=None,
             focal_alpha=0.5, focal_gamma=1.0,
             soft_clamp_value=5.0, background_clamp=-15.0):
    """x_all, t_all: (..., C) channel-last; returns summed loss."""
    x = x_all[..., xi[0]]
    t = t_all[..., ti[0]]

    mask = torch.nan_to_num(t, nan=-1.0) >= 0.0
    t_safe = _nan_to(t, mask, 0.0)
    t_sign = torch.where(t_safe > 0.0, 1.0, -1.0).to(x.dtype)

    x_detached = x.detach()
    p_bar = torch.sigmoid(-t_sign * x_detached)
    neg_ln_p = F.softplus(-t_sign * x_detached)

    focal = 1.0
    if focal_alpha:
        focal = focal * focal_alpha
    if focal_gamma == 1.0:
        p = 1.0 - p_bar
        focal = focal * (p_bar + p * neg_ln_p)
    elif focal_gamma > 0.0:
        p = 1.0 - p_bar
        focal = focal * (p_bar ** focal_gamma
                         + focal_gamma * p_bar ** (focal_gamma - 1.0)
                         * p * neg_ln_p)

    target = x_detached + t_sign * p_bar * focal
    l = smooth_l1(x - target)

    if background_clamp is not None:
        l = torch.where((x_detached < background_clamp) & (t_sign == -1.0),
                        torch.zeros_like(l), l)
    if soft_clamp_value:
        l = soft_clamp(l, soft_clamp_value)

    # uncertainty weighting of foreground
    fg = mask & (t_safe > 0.0)
    x_logs2 = _logs2(x_all[..., 0])
    l = torch.where(fg, 0.5 * l * torch.exp(-x_logs2) + 0.5 * x_logs2, l)

    if weights is not None:
        l = l * weights
    return torch.sum(torch.where(mask, l, torch.zeros_like(l)))


def regression_loss(x_all, t_all, *, xi, ti, weights=None,
                    sigma_from_scale=0.5, scale_from_wh=False,
                    soft_clamp_value=5.0):
    x_reg_x = x_all[..., xi[0]]
    x_reg_y = x_all[..., xi[1]]
    t_reg_x = t_all[..., ti[0]]
    t_reg_y = t_all[..., ti[1]]
    t_sigma_min = t_all[..., ti[2]]
    if scale_from_wh:
        # +eps: sqrt'(0) is inf and w = h = 0 does occur (empty targets)
        x_scales = torch.sqrt(x_all[..., xi[2]] ** 2
                              + x_all[..., xi[3]] ** 2 + 1e-12)
        t_scales = torch.sqrt(t_all[..., ti[3]] ** 2
                              + t_all[..., ti[4]] ** 2 + 1e-12)
    else:
        x_scales = x_all[..., xi[2]]
        t_scales = t_all[..., ti[3]]

    mask = torch.isfinite(t_reg_x) & torch.isfinite(t_reg_y)

    t_scales = torch.where(torch.isnan(t_scales),
                           F.softplus(x_scales.detach()), t_scales)
    t_sigma_min = torch.where(torch.isnan(t_sigma_min),
                              torch.full_like(t_sigma_min, 0.1), t_sigma_min)

    dx = x_reg_x - _nan_to(t_reg_x, mask, 0.0)
    dy = x_reg_y - _nan_to(t_reg_y, mask, 0.0)
    d = torch.sqrt(dx * dx + dy * dy + t_sigma_min * t_sigma_min + 1e-12)

    t_sigma = sigma_from_scale * t_scales
    l = d / torch.clamp(t_sigma, min=1e-6)
    if soft_clamp_value:
        l = soft_clamp(l, soft_clamp_value)

    x_logs2 = _logs2(x_all[..., 0])
    x_logb = 0.5 * x_logs2 + 0.69314
    l = l * torch.exp(-x_logb) + x_logb

    if weights is not None:
        l = l * weights
    return torch.sum(torch.where(mask, l, torch.zeros_like(l)))


def scale_loss(x_all, t_all, *, xi, ti, weights=None, b=1.0,
               relative_eps=0.1, soft_clamp_value=5.0, log_space=False):
    x = x_all[..., xi[0]]
    t = t_all[..., ti[0]]
    mask = torch.isfinite(t)
    t_safe = _nan_to(t, mask, 1.0 if log_space else 0.0)

    if log_space:
        # --scale-log: absolute log-space difference
        sp = F.softplus(x)
        d = torch.abs(torch.log(torch.clamp(sp, min=1e-10))
                      - torch.log(torch.clamp(t_safe, min=1e-10)))
        d = d / b
    else:
        d = torch.abs(F.softplus(x) - t_safe)
        d = d / (b * (relative_eps + t_safe))
    if soft_clamp_value:
        d = soft_clamp(d, soft_clamp_value)
    l = smooth_l1(d)

    if weights is not None:
        l = l * weights
    return torch.sum(torch.where(mask, l, torch.zeros_like(l)))


@dataclasses.dataclass
class CompositeLoss:
    """Per-head loss.

    ``__call__(x, t)`` with x (B, F, C, H, W) raw head output and t
    (B, F, Ct, H, W) encoded targets; returns a dict of summed losses per
    component group, each divided by batch size.
    """
    meta: headmeta.Base
    weights: Optional[torch.Tensor] = None

    @property
    def field_names(self):
        names = [f'{self.meta.dataset}.{self.meta.name}.c']
        if self.meta.n_vectors > 0:
            names.append(f'{self.meta.dataset}.{self.meta.name}.vec')
        if self.meta.n_scales > 0:
            names.append(f'{self.meta.dataset}.{self.meta.name}.scales')
        return names

    def __call__(self, x, t):
        meta = self.meta
        batch_size = x.shape[0]
        # channel-last views
        x = torch.movedim(x, 2, -1)
        t = torch.movedim(t, 2, -1)

        weights = None
        if meta.training_weights is not None:
            weights = torch.as_tensor(
                meta.training_weights, dtype=x.dtype, device=x.device
            ).reshape(1, -1, *([1] * (x.dim() - 3)))

        nv = meta.n_vectors
        ns = meta.n_scales
        cc = COMPONENT_CONFIG
        losses = {}
        losses[self.field_names[0]] = bce_loss(
            x, t, xi=[1], ti=[0], weights=weights,
            focal_alpha=cc.focal_alpha, focal_gamma=cc.focal_gamma,
            soft_clamp_value=cc.bce_soft_clamp,
            background_clamp=cc.bce_background_clamp) / batch_size

        if nv > 0:
            if nv <= ns:
                vec = sum(
                    regression_loss(
                        x, t,
                        xi=[2 + vi * 2, 2 + vi * 2 + 1, 2 + nv * 2 + vi],
                        ti=[1 + vi * 2, 1 + vi * 2 + 1, 1 + nv * 2 + vi,
                            1 + nv * 3 + vi],
                        weights=weights,
                        soft_clamp_value=cc.regression_soft_clamp)
                    for vi in range(nv))
            elif nv == 2 and ns == 0:
                # detection: scale from w/h channels
                vec = sum(
                    regression_loss(
                        x, t,
                        xi=[2 + vi * 2, 2 + vi * 2 + 1, 2 + 2, 2 + 3],
                        ti=[1 + vi * 2, 1 + vi * 2 + 1, 1 + 4 + vi, 1 + 2,
                            1 + 3],
                        weights=weights,
                        soft_clamp_value=cc.regression_soft_clamp,
                        sigma_from_scale=0.1, scale_from_wh=True)
                    for vi in range(nv))
            else:
                vec = None
            if vec is not None:
                losses[f'{meta.dataset}.{meta.name}.vec'] = vec / batch_size

        if ns > 0:
            losses[f'{meta.dataset}.{meta.name}.scales'] = sum(
                scale_loss(
                    x, t,
                    xi=[2 + nv * 2 + si],
                    ti=[1 + nv * 3 + si],
                    weights=weights,
                    b=cc.b_scale, log_space=cc.scale_log,
                    soft_clamp_value=cc.scale_soft_clamp)
                for si in range(ns)) / batch_size

        return losses


class MultiHeadLossBase:
    """Common interface: every multi-head loss is a function of
    (head_outputs, targets, loss_params, loss_state) returning
    (total, flat_head_losses, new_loss_state). ``loss_params`` are
    trainable (Kendall log-sigmas), ``loss_state`` is running non-trainable
    state (variance buffers); both are dicts of tensors, maybe empty, that
    the trainer owns."""

    def __init__(self, losses, lambdas=None):
        self.losses = losses
        self.field_names = [n for l in losses for n in l.field_names]
        if not lambdas:
            lambdas = [1.0 for _ in self.field_names]
        if any(lam < 0.0 for lam in lambdas):
            raise ValueError(f'negative loss lambdas {lambdas}')
        if len(lambdas) != len(self.field_names):
            raise ValueError(f'{len(lambdas)} lambdas for '
                             f'{len(self.field_names)} loss components')
        self.lambdas = lambdas

    def init_params(self):
        return {}

    def init_state(self):
        return {}

    def _flat_losses(self, head_outputs, targets):
        all_components = {}
        for loss, x, t in zip(self.losses, head_outputs, targets):
            if t is None:
                continue
            all_components.update(loss(x, t))
        return [all_components.get(n) for n in self.field_names]

    def __call__(self, head_outputs, targets, loss_params=None,
                 loss_state=None):
        raise NotImplementedError


class MultiHeadLoss(MultiHeadLossBase):
    """Lambda-weighted sum over heads."""

    def __call__(self, head_outputs, targets, loss_params=None,
                 loss_state=None):
        flat = self._flat_losses(head_outputs, targets)
        total = sum(
            lam * l for lam, l in zip(self.lambdas, flat) if l is not None)
        return total, flat, (loss_state or {})


class MultiHeadLossAutoTuneKendall(MultiHeadLossBase):
    """Learned per-component log-sigma weighting, from Kendall/Gal/Cipolla's
    uncertainty-based multi-task weighting."""

    def __init__(self, losses, lambdas=None, *, tune=None):
        super().__init__(losses, lambdas)
        if tune is None:
            def tune_from_name(name):
                if '.vec' in name:
                    return 'none'
                if '.scale' in name:
                    return 'laplace'
                return 'gauss'
            tune = [tune_from_name(n) for n in self.field_names]
        self.tune = tune

    def init_params(self):
        return {'log_sigmas': torch.zeros((len(self.lambdas),))}

    def __call__(self, head_outputs, targets, loss_params=None,
                 loss_state=None):
        flat = self._flat_losses(head_outputs, targets)
        log_sigmas = 3.0 * torch.tanh(loss_params['log_sigmas'] / 3.0)

        def tuned_loss(tune, log_sigma, loss):
            if tune == 'none':
                return loss
            if tune == 'laplace':
                # negative ln of a Laplace; ln(2) = 0.694
                return 0.694 + log_sigma + loss * torch.exp(-log_sigma)
            if tune == 'gauss':
                # negative ln of a Gaussian; ln(sqrt(2pi)) = 0.919
                return (0.919 + log_sigma
                        + loss * 0.5 * torch.exp(-2.0 * log_sigma))
            raise ValueError(f'unknown tune: {tune}')

        total = sum(
            lam * tuned_loss(t, log_sigmas[i], l)
            for i, (lam, t, l) in enumerate(zip(self.lambdas, self.tune,
                                                flat))
            if l is not None)
        return total, flat, (loss_state or {})


class MultiHeadLossAutoTuneVariance(MultiHeadLossBase):
    """Running-variance loss normalization: each component is divided by
    the standard deviation of its last 53 values (prime buffer length),
    normalized so sum(1/eps) is constant. In a data-parallel step
    (``process_group`` set) the buffer takes each component's mean over
    the ranks, so that every rank's normaliser moves alike."""

    buffer_len = 53
    process_group = None

    def _buffer_values(self, flat):
        """The detached values the buffer takes: the rank's own, or their
        mean over ``process_group``."""
        values = [l.detach() if l is not None else None for l in flat]
        if self.process_group is None:
            return values
        return rank_mean(values, self.process_group)

    def init_state(self):
        n = len(self.lambdas)
        return {
            'buffer': torch.full((n, self.buffer_len), float('nan')),
            'index': torch.tensor(-1, dtype=torch.int32),
        }

    def __call__(self, head_outputs, targets, loss_params=None,
                 loss_state=None):
        flat = self._flat_losses(head_outputs, targets)

        index = (loss_state['index'] + 1) % self.buffer_len
        buffer = loss_state['buffer'].clone()
        for i, value in enumerate(self._buffer_values(flat)):
            if value is None:
                continue
            buffer[i, index.long()] = value

        epsilons = torch.sqrt(
            torch.mean(buffer ** 2, dim=1)
            - torch.sum(buffer, dim=1) ** 2 / self.buffer_len ** 2)
        epsilons = torch.where(torch.isnan(epsilons),
                               torch.full_like(epsilons, 10.0), epsilons)
        epsilons = torch.clamp(epsilons, 0.01, 100.0)
        epsilons = epsilons * torch.sum(1.0 / epsilons) / epsilons.shape[0]

        total = sum(
            lam * l / epsilons[i]
            for i, (lam, l) in enumerate(zip(self.lambdas, flat))
            if l is not None)
        new_state = {'buffer': buffer, 'index': index}
        return total, flat, new_state


#: the loss of each head meta; the lookup is by exact type, as in JAX
LOSSES = {
    headmeta.Cif: CompositeLoss,
    headmeta.Caf: CompositeLoss,
    headmeta.CifDet: CompositeLoss,
    headmeta.TSingleImageCif: CompositeLoss,
    headmeta.TSingleImageCaf: CompositeLoss,
    headmeta.Tcaf: CompositeLoss,
}


class Factory:
    lambdas = None
    component_lambdas = None
    auto_tune_mtl = False
    auto_tune_mtl_variance = False
    task_sparsity_weight = 0.0

    @classmethod
    def cli(cls, parser):
        group = parser.add_argument_group('losses')
        group.add_argument('--lambdas', default=cls.lambdas, type=float,
                           nargs='+', help='prefactor for head losses by head')
        group.add_argument('--component-lambdas',
                           default=cls.component_lambdas,
                           type=float, nargs='+',
                           help='prefactor for head losses by component')
        group.add_argument('--auto-tune-mtl', default=False,
                           action='store_true',
                           help='[experimental] use Kendall\'s prescription '
                                'for adjusting the multitask weight')
        group.add_argument('--auto-tune-mtl-variance', default=False,
                           action='store_true',
                           help='[experimental] use loss-variance '
                                'normalization for the multitask weights')
        group.add_argument('--task-sparsity-weight',
                           default=cls.task_sparsity_weight, type=float,
                           help='L1 sparsity penalty on head conv weights')

        cc = COMPONENT_CONFIG
        group = parser.add_argument_group('Bce Loss')
        group.add_argument('--focal-alpha', default=cc.focal_alpha,
                           type=float, help='scale parameter of focal loss')
        group.add_argument('--focal-gamma', default=cc.focal_gamma,
                           type=float,
                           help='use focal loss with the given gamma')
        group.add_argument('--bce-soft-clamp', default=cc.bce_soft_clamp,
                           type=float, help='soft clamp for BCE')
        group.add_argument('--bce-background-clamp',
                           default=cc.bce_background_clamp, type=float,
                           help='background clamp for BCE')

        group = parser.add_argument_group('Scale Loss')
        group.add_argument('--b-scale', default=cc.b_scale, type=float,
                           help='Laplace width b for scale loss')
        group.add_argument('--scale-log', default=False, action='store_true')
        group.add_argument('--scale-soft-clamp', default=cc.scale_soft_clamp,
                           type=float, help='soft clamp for scale')

        group = parser.add_argument_group('Regression loss')
        group.add_argument('--regression-soft-clamp',
                           default=cc.regression_soft_clamp,
                           type=float, help='soft clamp for regression')

    @classmethod
    def configure(cls, args):
        cls.lambdas = args.lambdas
        cls.component_lambdas = args.component_lambdas
        cls.auto_tune_mtl = args.auto_tune_mtl
        cls.auto_tune_mtl_variance = args.auto_tune_mtl_variance
        cls.task_sparsity_weight = args.task_sparsity_weight

        cc = COMPONENT_CONFIG
        cc.focal_alpha = args.focal_alpha
        cc.focal_gamma = args.focal_gamma
        cc.bce_soft_clamp = args.bce_soft_clamp
        cc.bce_background_clamp = args.bce_background_clamp
        cc.b_scale = args.b_scale
        cc.scale_log = args.scale_log
        cc.scale_soft_clamp = args.scale_soft_clamp
        cc.regression_soft_clamp = args.regression_soft_clamp

    def factory(self, head_metas):
        losses = [LOSSES[type(meta)](meta) for meta in head_metas]

        component_lambdas = self.component_lambdas
        if component_lambdas is None and self.lambdas is not None:
            if len(self.lambdas) != len(head_metas):
                raise ValueError(f'{len(self.lambdas)} --lambdas for '
                                 f'{len(head_metas)} heads')
            component_lambdas = [
                head_lambda
                for loss, head_lambda in zip(losses, self.lambdas)
                for _ in loss.field_names
            ]

        if self.auto_tune_mtl:
            loss = MultiHeadLossAutoTuneKendall(losses, component_lambdas)
        elif self.auto_tune_mtl_variance:
            loss = MultiHeadLossAutoTuneVariance(losses, component_lambdas)
        else:
            loss = MultiHeadLoss(losses, component_lambdas)
        # L1 head-sparsity penalty added by the trainer on head conv
        # kernels
        loss.task_sparsity_weight = self.task_sparsity_weight
        return loss
