"""Optimizers and learning-rate schedules.

Counterpart of ``s2st_tpu/train/optim.py``. The schedules (:23-224) map
the 1-based update count to the rate, as JAX's do, in float64 on the host
(JAX computes them in float32 on the device; the two agree within float32's
rounding). ``SCHEDULE_REGISTRY`` and ``build_schedule`` (:88-224) are JAX's
names, and ``build_schedule`` passes each function only the keyword
arguments it accepts, so that a schedule with a required argument the
caller did not give raises ``TypeError``, as JAX's CLI does for
``polynomial_decay``, ``cosine`` and ``tri_stage``.

The optimizers (:227-338) are optax's transforms without the rate, over a
list of tensors updated in place: ``step(grads, lr)`` computes the
transform's update ``u`` and applies ``p -= lr * u``, as the JAX trainer
does (``trainer.py:231-235``). Each follows optax's order of operations,
epsilons and bias corrections (optax 0.2: ``scale_by_adam``,
``scale_by_factored_rms`` with ``clip_by_block_rms``,
``scale_by_param_block_rms`` and ``scale(-1)``, ``trace``,
``scale_by_rss``, ``scale_by_adadelta``, ``scale_by_adamax``,
``add_decayed_weights``, ``scale_by_trust_ratio``, ``scale_by_rms``).
``OPTIMIZER_REGISTRY`` takes JAX's names and defaults.

Each optimizer names its state as ``s2st_tpu/train/checkpoint.py::
flatten_tree`` names optax's (``PREFIX`` and ``state()``): ``opt::0::.``
for a chain's first member (``adam``, ``lamb``, ``adafactor``), ``opt::.``
for a bare transform, then the field (``count``, ``mu``, ``v_row``, ...).
``state()`` gives each field's tensors in the order of the parameters; a
field in ``JAX_LAYOUT_FIELDS`` is held in JAX's layout of its parameter
(adafactor's factored statistics depend on which axes are the two
largest, and JAX's (in, out) Linear and (K, in, out) conv weights are
PyTorch's transposed), every other field in PyTorch's.
"""

from __future__ import annotations

import ast
import inspect
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

OPT_CHAIN = "opt::0::."
OPT_BARE = "opt::."


# ---------------------------------------------------------------------------
# schedules: 1-based update count -> lr
# ---------------------------------------------------------------------------

def inverse_sqrt_schedule(lr: float, warmup_updates: int = 4000,
                          warmup_init_lr: float = -1.0
                          ) -> Callable[[int], float]:
    """num_updates (1-based) -> lr: a linear warmup from ``warmup_init_lr``
    to ``lr`` over ``warmup_updates``, then lr * sqrt(warmup / n)."""
    if warmup_init_lr < 0:
        warmup_init_lr = 0.0 if warmup_updates > 0 else lr
    lr_step = (lr - warmup_init_lr) / max(warmup_updates, 1)
    decay_factor = lr * warmup_updates ** 0.5 if warmup_updates > 0 else lr

    def sched(num_updates: int) -> float:
        if num_updates < warmup_updates:
            return warmup_init_lr + num_updates * lr_step
        return decay_factor / math.sqrt(max(num_updates, 1))
    return sched


def fixed_schedule(lr: float, warmup_updates: int = 0
                   ) -> Callable[[int], float]:
    """lr * min((num_updates + 1) / warmup, 1), or lr without warmup."""
    def sched(num_updates: int) -> float:
        if warmup_updates <= 0:
            return lr
        return lr * min((num_updates + 1) / warmup_updates, 1.0)
    return sched


def polynomial_decay_schedule(lr: float, total_num_update: int,
                              warmup_updates: int = 0,
                              end_learning_rate: float = 0.0,
                              power: float = 1.0) -> Callable[[int], float]:
    def sched(t: int) -> float:
        if t < warmup_updates:
            return lr * t / max(warmup_updates, 1)
        pct = 1.0 - (t - warmup_updates) / max(
            total_num_update - warmup_updates, 1)
        return (lr - end_learning_rate) * max(pct, 0.0) ** power \
            + end_learning_rate
    return sched


def cosine_schedule(lr: float, warmup_updates: int, max_update: int,
                    min_lr: float = 0.0) -> Callable[[int], float]:
    def sched(t: int) -> float:
        if t < warmup_updates:
            return min_lr + (lr - min_lr) * t / max(warmup_updates, 1)
        pct = (t - warmup_updates) / max(max_update - warmup_updates, 1)
        return min_lr + 0.5 * (lr - min_lr) * (
            1 + math.cos(math.pi * min(pct, 1.0)))
    return sched


def tri_stage_schedule(lr: float, warmup_steps: int, hold_steps: int,
                       decay_steps: int, init_lr_scale: float = 0.01,
                       final_lr_scale: float = 0.01
                       ) -> Callable[[int], float]:
    init_lr, final_lr = init_lr_scale * lr, final_lr_scale * lr
    factor = -math.log(max(final_lr_scale, 1e-8)) / max(decay_steps, 1)

    def sched(t: int) -> float:
        if t < warmup_steps:
            out = init_lr + (lr - init_lr) * min(t / max(warmup_steps, 1),
                                                 1.0)
        elif t < warmup_steps + hold_steps:
            out = lr
        else:
            decay_t = min(max(t - warmup_steps - hold_steps, 0),
                          decay_steps)
            out = lr * math.exp(-factor * decay_t)
        return max(out, final_lr)
    return sched


def step_schedule(lr: float, warmup_updates: int = 0,
                  decay_updates: int = 50000, decay_factor: float = 0.5
                  ) -> Callable[[int], float]:
    def sched(t: int) -> float:
        warm = min(t / max(warmup_updates, 1), 1.0)
        return lr * warm * decay_factor ** math.floor(t / decay_updates)
    return sched


def triangular_schedule(lr: float, warmup_updates: int = 0,
                        max_lr: Optional[float] = None, period: int = 5000
                        ) -> Callable[[int], float]:
    max_lr = max_lr or lr * 10

    def sched(t: int) -> float:
        cycle = abs((t / period) % 2.0 - 1.0)
        return lr + (max_lr - lr) * (1.0 - cycle)
    return sched


def pass_through_schedule(lr: float, **kw) -> Callable[[int], float]:
    return lambda num_updates: lr


def manual_schedule(lr: float, epoch2lr: Optional[dict] = None,
                    update2lr: Optional[dict] = None
                    ) -> Callable[[int], float]:
    """A staircase over the sorted ``update2lr`` breakpoints; ``epoch2lr``
    raises, as in JAX, where the CLI drives it through ``manual_lr_host``
    and ``lr_scale`` instead."""
    if epoch2lr:
        raise ValueError(
            "manual_schedule cannot apply epoch2lr on device; use "
            "manual_lr_host(...) and drive lr_scale from the CLI")
    points = sorted((update2lr or {}).items())

    def sched(t: int) -> float:
        out = lr
        for boundary, value in points:
            if t >= boundary:
                out = value
        return out
    return sched


def parse_manual_lr_dict(s: str) -> dict:
    """``--epoch2lr``/``--update2lr``: a dict whose keys are "5", "1,2,3"
    or the inclusive range "3-10", and whose values are floats."""
    raw = ast.literal_eval(str(s).replace(" ", ""))
    if not isinstance(raw, dict):
        raise ValueError("epoch2lr/update2lr must evaluate to a dict")
    out: dict = {}
    for key, val in raw.items():
        key = str(key)
        if "," in key:
            for k in key.split(","):
                out[int(k)] = float(val)
        elif "-" in key:
            start, end = key.split("-")
            for k in range(int(start), int(end) + 1):
                out[int(k)] = float(val)
        else:
            out[int(key)] = float(val)
    return out


def manual_lr_host(lr: float, epoch2lr: Optional[dict] = None,
                   update2lr: Optional[dict] = None
                   ) -> Callable[[int, int], float]:
    """fn(epoch, num_updates) -> lr: ``update2lr`` at its largest key <=
    num_updates if there is one, else ``epoch2lr`` at its largest key <=
    epoch, else ``lr``."""
    epoch2lr = epoch2lr or {}
    update2lr = update2lr or {}
    u_keys = sorted(update2lr)
    e_keys = sorted(epoch2lr)

    def fn(epoch: int, num_updates: int) -> float:
        uk = [k for k in u_keys if k <= num_updates]
        if uk:
            return update2lr[uk[-1]]
        ek = [k for k in e_keys if k <= epoch]
        if ek:
            return epoch2lr[ek[-1]]
        return lr
    return fn


def reduce_on_plateau_schedule(lr: float, warmup_updates: int = 0
                               ) -> Callable[[int], float]:
    """The fixed schedule with its warmup; the CLI applies the shrink
    through ``lr_scale``."""
    return fixed_schedule(lr, warmup_updates)


SCHEDULE_REGISTRY: Dict[str, Callable] = {
    "inverse_sqrt": inverse_sqrt_schedule,
    "fixed": fixed_schedule,
    "polynomial_decay": polynomial_decay_schedule,
    "cosine": cosine_schedule,
    "tri_stage": tri_stage_schedule,
    "step": step_schedule,
    "triangular": triangular_schedule,
    "pass_through": pass_through_schedule,
    "reduce_lr_on_plateau": reduce_on_plateau_schedule,
    "reduce_on_plateau": reduce_on_plateau_schedule,
    "manual": manual_schedule,
}
PLATEAU = ("reduce_lr_on_plateau", "reduce_on_plateau")


def build_schedule(name: str, lr: float, **kw) -> Callable[[int], float]:
    """The named schedule with the keyword arguments it accepts."""
    fn = SCHEDULE_REGISTRY[name]
    accepted = set(inspect.signature(fn).parameters)
    return fn(lr, **{k: v for k, v in kw.items() if k in accepted})


def schedule_from_args(args) -> Callable[[int], float]:
    """The schedule as the JAX training CLI builds it (cli/train.py:
    107-123): only ``warmup_updates`` reaches it, and ``warmup_init_lr``
    the inverse-sqrt one, where a negative value (the default) becomes
    ``--lr`` itself, so the warmup holds the rate flat; under
    ``--lr-scheduler manual`` it is ``pass_through`` and the CLI drives
    ``lr_scale`` from ``manual_lr_from_args``."""
    lr = float(str(args.lr).split(",")[0])
    if args.lr_scheduler == "manual":
        return build_schedule("pass_through", lr)
    kw = dict(warmup_updates=args.warmup_updates)
    if args.lr_scheduler == "inverse_sqrt":
        kw["warmup_init_lr"] = args.warmup_init_lr \
            if args.warmup_init_lr >= 0 else lr
    return build_schedule(args.lr_scheduler, lr, **kw)


def manual_lr_from_args(args) -> Optional[Callable[[int, int], float]]:
    """``manual_lr_host`` over ``--epoch2lr`` and ``--update2lr`` under
    ``--lr-scheduler manual`` (cli/train.py:112-121), else None."""
    if args.lr_scheduler != "manual":
        return None
    return manual_lr_host(
        float(str(args.lr).split(",")[0]),
        parse_manual_lr_dict(getattr(args, "epoch2lr", "{}")),
        parse_manual_lr_dict(getattr(args, "update2lr", "{}")))


# ---------------------------------------------------------------------------
# optimizers: transforms without the lr over a list of tensors
# ---------------------------------------------------------------------------

def to_jax_view(t: torch.Tensor, kind: str) -> torch.Tensor:
    """A view of a parameter-shaped tensor in JAX's layout of its leaf."""
    if kind == "linear":
        return t.t()
    if kind == "conv":
        return t.permute(2, 1, 0)
    if kind == "conv2d":
        return t.permute(2, 3, 1, 0)
    if kind == "heads_k":
        return t[:, 0, :]
    if kind == "scalar":
        return t.view(())
    return t


def from_jax_view(t: torch.Tensor, kind: str) -> torch.Tensor:
    """The inverse of ``to_jax_view``."""
    if kind == "heads_k":
        return t[:, None, :]
    if kind == "conv2d":
        return t.permute(3, 2, 0, 1)
    if kind == "scalar":
        return t.view(1)
    return to_jax_view(t, kind)


class Transform:
    """An optax transform over ``params`` (updated in place by ``step``).
    ``kinds``: each parameter's layout kind (``models/jax_bridge.py``), for
    transforms whose state follows JAX's layout."""

    PREFIX = OPT_BARE
    FIELDS: Tuple[str, ...] = ()
    JAX_LAYOUT_FIELDS: Tuple[str, ...] = ()
    has_count = False

    def __init__(self, params: Sequence[torch.Tensor],
                 kinds: Optional[Sequence[str]] = None):
        self.params: List[torch.Tensor] = list(params)
        self.kinds = list(kinds) if kinds is not None \
            else ["same"] * len(self.params)
        self.count = 0

    def _zeros(self) -> List[torch.Tensor]:
        return [torch.zeros_like(p) for p in self.params]

    def state(self) -> List[Tuple[str, List[torch.Tensor]]]:
        """(field, its tensor for each parameter) in checkpoint order."""
        return [(f, getattr(self, f)) for f in self.FIELDS]

    def update(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], lr: float) -> None:
        torch._foreach_add_(self.params, self.update(grads), alpha=-lr)


class Identity(Transform):
    """``optax.identity``: ``sgd`` without momentum."""

    def update(self, grads):
        return list(grads)


class Trace(Transform):
    """``optax.trace``: t = g + decay * t; the update is t, or g + decay *
    t with ``nesterov`` (``sgd`` with momentum, ``nag``)."""

    FIELDS = ("trace",)

    def __init__(self, params, kinds=None, decay: float = 0.99,
                 nesterov: bool = False):
        super().__init__(params, kinds)
        self.decay = decay
        self.nesterov = nesterov
        self.trace = self._zeros()

    def update(self, grads):
        t = torch._foreach_add(grads, torch._foreach_mul(self.trace,
                                                          self.decay))
        torch._foreach_copy_(self.trace, t)
        if self.nesterov:
            return torch._foreach_add(grads, torch._foreach_mul(
                self.trace, self.decay))
        return t


class Adagrad(Transform):
    """``optax.scale_by_rss``: s = g^2 + s from 0.1, u = g / sqrt(s + eps)
    where s > 0."""

    FIELDS = ("sum_of_squares",)

    def __init__(self, params, kinds=None,
                 initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        super().__init__(params, kinds)
        self.eps = eps
        self.sum_of_squares = [torch.full_like(p, initial_accumulator_value)
                               for p in self.params]

    def update(self, grads):
        torch._foreach_addcmul_(self.sum_of_squares, grads, grads)
        out = []
        for g, s in zip(grads, self.sum_of_squares):
            out.append(torch.where(s > 0, torch.rsqrt(s + self.eps),
                                   torch.zeros_like(s)) * g)
        return out


class Adadelta(Transform):
    """``optax.scale_by_adadelta``."""

    FIELDS = ("e_g", "e_x")

    def __init__(self, params, kinds=None, rho: float = 0.9,
                 eps: float = 1e-6):
        super().__init__(params, kinds)
        self.rho, self.eps = rho, eps
        self.e_g = self._zeros()
        self.e_x = self._zeros()

    def update(self, grads):
        rho, eps = self.rho, self.eps
        out = []
        for g, e_g, e_x in zip(grads, self.e_g, self.e_x):
            e_g.copy_((1 - rho) * g * g + rho * e_g)
            u = torch.sqrt(e_x + eps) / torch.sqrt(e_g + eps) * g
            e_x.copy_((1 - rho) * u * u + rho * e_x)
            out.append(u)
        return out


class Adamax(Transform):
    """``optax.scale_by_adamax``: the infinity norm in ``nu``."""

    FIELDS = ("mu", "nu")
    has_count = True

    def __init__(self, params, kinds=None,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8):
        super().__init__(params, kinds)
        self.betas, self.eps = betas, eps
        self.mu = self._zeros()
        self.nu = self._zeros()

    def state(self):
        return [("mu", self.mu), ("nu", self.nu)]

    def update(self, grads):
        b1, b2 = self.betas
        self.count += 1
        bc1 = 1.0 - b1 ** self.count
        out = []
        for g, mu, nu in zip(grads, self.mu, self.nu):
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_(torch.maximum(g.abs() + self.eps, b2 * nu))
            out.append(mu / bc1 / nu)
        return out


class RMSProp(Transform):
    """``optax.scale_by_rms`` (no bias correction, eps inside the root)."""

    FIELDS = ("nu",)

    def __init__(self, params, kinds=None, decay: float = 0.99,
                 eps: float = 1e-8):
        super().__init__(params, kinds)
        self.decay, self.eps = decay, eps
        self.nu = self._zeros()

    def update(self, grads):
        d = self.decay
        out = []
        for g, nu in zip(grads, self.nu):
            nu.copy_((1 - d) * g * g + d * nu)
            out.append(torch.rsqrt(nu + self.eps) * g)
        return out


class Adam(Transform):
    """Adam over a list of tensors, updated in place (the port's params are
    the model's own). ``step(grads, lr)`` is one optax ``scale_by_adam``
    update, plus ``weight_decay * p``, followed by ``p -= lr * u``;
    ``count`` is the number of updates taken. With ``stats_dtype`` the
    moments are stored in that dtype and the update uses their fp32 values
    before rounding, as ``scale_by_adam_dtyped`` does. Its state is the
    first member of optax's chain (``opt::0::.``) with or without the
    decayed weights."""

    PREFIX = OPT_CHAIN
    FIELDS = ("mu", "nu")
    has_count = True

    def __init__(self, params: Sequence[torch.Tensor],
                 betas: Tuple[float, float] = (0.9, 0.98), eps: float = 1e-8,
                 weight_decay: float = 0.0, stats_dtype=None,
                 kinds: Optional[Sequence[str]] = None):
        super().__init__(params, kinds)
        self.betas = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.stats_dtype = stats_dtype
        self.mu = [torch.zeros_like(p, dtype=stats_dtype)
                   for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=stats_dtype)
                   for p in self.params]

    def _moments(self, grads):
        """The new moments (fp32), the bias corrections and the denominator
        sqrt(nu_hat) + eps; the count advances."""
        b1, b2 = self.betas
        self.count += 1
        if self.stats_dtype is None:
            mu, nu = self.mu, self.nu
        else:
            mu = [m.float() for m in self.mu]
            nu = [v.float() for v in self.nu]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
        bc1 = 1.0 - b1 ** self.count
        bc2 = 1.0 - b2 ** self.count
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        if self.stats_dtype is not None:
            torch._foreach_copy_(self.mu, mu)
            torch._foreach_copy_(self.nu, nu)
        return mu, bc1, denom

    def update(self, grads):
        mu, bc1, denom = self._moments(grads)
        u = torch._foreach_div(mu, denom)
        torch._foreach_div_(u, bc1)
        if self.weight_decay:
            torch._foreach_add_(u, self.params, alpha=self.weight_decay)
        return u

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], lr: float) -> None:
        mu, bc1, denom = self._moments(grads)
        if self.weight_decay:
            torch._foreach_add_(self.params, self.params,
                                alpha=-lr * self.weight_decay)
        torch._foreach_addcdiv_(self.params, mu, denom, value=-lr / bc1)


class Lamb(Adam):
    """``lamb``: optax's chain of ``scale_by_adam``,
    ``add_decayed_weights`` and ``scale_by_trust_ratio``: each parameter's
    update times ||p|| / ||u||, or 1 where either norm is 0. Every port
    parameter is one JAX leaf (``models/jax_bridge.py``), so the norms are
    the leaf's."""

    def __init__(self, params, kinds=None,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, betas, eps, weight_decay, kinds=kinds)

    def update(self, grads):
        u = super().update(grads)
        p_norms = torch._foreach_norm(self.params)
        u_norms = torch._foreach_norm(u)
        ratios = [torch.where((pn == 0) | (un == 0), torch.ones_like(pn),
                              pn / un) for pn, un in zip(p_norms, u_norms)]
        torch._foreach_mul_(u, ratios)
        return u

    step = Transform.step


def _factored_dims(shape, min_dim_size_to_factor: int = 128
                   ) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims``: the second largest and the largest axis
    (numpy's argsort), when the second is at least the minimum."""
    if len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


class Adafactor(Transform):
    """``optax.adafactor(learning_rate=None)``: ``scale_by_factored_rms``
    (decay 1 - (count + 1)^-0.8, eps 1e-30 added to g^2, the two largest
    axes of a leaf factored when the second is at least 128), then
    ``clip_by_block_rms(1.0)``, ``scale_by_param_block_rms`` (the update
    times max(rms(p), 1e-3)), ``add_decayed_weights`` under a weight decay
    and ``scale(-1)``. The statistics are computed and kept in JAX's
    layout of each leaf, so ``v_row``/``v_col``/``v`` have JAX's shapes
    (``(1,)`` where a leaf does not use them)."""

    PREFIX = OPT_CHAIN
    FIELDS = ("v_row", "v_col", "v")
    JAX_LAYOUT_FIELDS = FIELDS
    has_count = True

    def __init__(self, params, kinds=None, weight_decay: float = 0.0,
                 decay_rate: float = 0.8, min_dim_size_to_factor: int = 128,
                 eps: float = 1e-30, clipping_threshold: float = 1.0,
                 min_scale: float = 1e-3):
        super().__init__(params, kinds)
        self.weight_decay = weight_decay
        self.decay_rate = decay_rate
        self.eps = eps
        self.clipping_threshold = clipping_threshold
        self.min_scale = min_scale
        self.dims, self.v_row, self.v_col, self.v = [], [], [], []
        for p, kind in zip(self.params, self.kinds):
            shape = tuple(to_jax_view(p, kind).shape)
            dims = _factored_dims(shape, min_dim_size_to_factor)
            self.dims.append(dims)
            one = p.new_zeros((1,))
            if dims is None:
                self.v_row.append(one)
                self.v_col.append(one.clone())
                self.v.append(p.new_zeros(shape))
            else:
                d1, d0 = dims
                self.v_row.append(p.new_zeros(np.delete(shape, d0).tolist()))
                self.v_col.append(p.new_zeros(np.delete(shape, d1).tolist()))
                self.v.append(one)

    def update(self, grads):
        t = np.float32(self.count + 1)
        decay = float(np.float32(1.0) - t ** np.float32(-self.decay_rate))
        self.count += 1
        out = []
        for i, (g, p, kind) in enumerate(zip(grads, self.params,
                                             self.kinds)):
            g = to_jax_view(g, kind)
            g2 = g * g + self.eps
            dims = self.dims[i]
            if dims is None:
                v = self.v[i]
                v.copy_(decay * v + (1.0 - decay) * g2)
                u = g * v ** -0.5
            else:
                d1, d0 = dims
                v_row, v_col = self.v_row[i], self.v_col[i]
                v_row.copy_(decay * v_row + (1.0 - decay) * g2.mean(d0))
                v_col.copy_(decay * v_col + (1.0 - decay) * g2.mean(d1))
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_col_mean = v_row.mean(reduced_d1, keepdim=True)
                row_factor = (v_row / row_col_mean) ** -0.5
                col_factor = v_col ** -0.5
                u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            rms = torch.sqrt(torch.mean(u * u))
            u = u / torch.clamp(rms / self.clipping_threshold, min=1.0)
            pj = to_jax_view(p, kind)
            p_rms = torch.sqrt(torch.mean(pj * pj))
            u = u * torch.where(p_rms <= self.min_scale,
                                torch.full_like(p_rms, self.min_scale), p_rms)
            if self.weight_decay:
                u = u + self.weight_decay * pj
            out.append(from_jax_view(-u, kind))
        return out


def adam(params, kinds=None, betas: Tuple[float, float] = (0.9, 0.999),
         eps: float = 1e-8, weight_decay: float = 0.0, stats_dtype=None):
    return Adam(params, betas, eps, weight_decay, stats_dtype, kinds=kinds)


def adafactor(params, kinds=None, weight_decay: float = 0.0):
    return Adafactor(params, kinds, weight_decay=weight_decay)


def sgd(params, kinds=None, momentum: float = 0.0):
    if momentum > 0:
        return Trace(params, kinds, decay=momentum)
    return Identity(params, kinds)


def adagrad(params, kinds=None):
    return Adagrad(params, kinds)


def adadelta(params, kinds=None, rho: float = 0.9, eps: float = 1e-6):
    return Adadelta(params, kinds, rho=rho, eps=eps)


def adamax(params, kinds=None, betas: Tuple[float, float] = (0.9, 0.999),
           eps: float = 1e-8):
    return Adamax(params, kinds, betas=betas, eps=eps)


def nag(params, kinds=None, momentum: float = 0.99):
    return Trace(params, kinds, decay=momentum, nesterov=True)


def lamb(params, kinds=None, betas: Tuple[float, float] = (0.9, 0.999),
         eps: float = 1e-8, weight_decay: float = 0.0):
    return Lamb(params, kinds, betas=betas, eps=eps,
                weight_decay=weight_decay)


def rmsprop(params, kinds=None, decay: float = 0.99, eps: float = 1e-8):
    return RMSProp(params, kinds, decay=decay, eps=eps)


OPTIMIZER_REGISTRY: Dict[str, Callable[..., Transform]] = {
    "adam": adam,
    "adafactor": adafactor,
    "sgd": sgd,
    "adagrad": adagrad,
    "adadelta": adadelta,
    "adamax": adamax,
    "nag": nag,
    "lamb": lamb,
    "rmsprop": rmsprop,
}


def build_optimizer(name: str, params: Sequence[torch.Tensor],
                    kinds: Optional[Sequence[str]] = None, **kw
                    ) -> Transform:
    return OPTIMIZER_REGISTRY[name](params, kinds, **kw)


def optimizer_kwargs(args) -> dict:
    """What JAX's CLI passes the optimizer (cli/train.py:124-133): the
    Adam flags to ``adam`` only; every other optimizer takes its
    defaults."""
    if args.optimizer != "adam":
        return {}
    kw = dict(betas=tuple(float(b) for b in str(args.adam_betas)
                          .strip("()[] ").split(",")),
              eps=args.adam_eps, weight_decay=args.weight_decay)
    if getattr(args, "adam_bf16_stats", False):
        kw["stats_dtype"] = torch.bfloat16
    return kw
