"""Optimization methods and learning-rate schedules (port of
``bigdl_tpu/optim/optim_method.py``: the schedules, ``OptimMethod`` with
the flat ``optimize(feval, x)`` API and ``save`` / ``load`` /
``clear_history``, ``SGD``, ``Adam``, ``AdamW``, ``Adagrad``,
``Adadelta``, ``Adamax``, ``RMSprop``, ``Ftrl``, ``LBFGS`` (flat API
only, as in JAX) and ``ParallelAdam``).

As in the JAX package each method is split in two:

- a functional update ``step(params, grads, slots, lr) -> (new_params,
  new_slots)`` on a list of tensors (or one tensor), which allocates new
  tensors and changes none of its inputs;
- a host-side schedule that computes the scalar rate of each iteration
  from the method's state table (``epoch`` / ``neval`` / ``score``) and
  is passed into the step.

These are not ``torch.optim`` wrappers: ``SGD``'s ``dampening``
defaults to ``momentum`` (BigDL's rule; ``torch.optim.SGD`` defaults it
to 0), weight decay enters the gradient, and Adam's bias correction is
computed in f32 from an integer step count kept in its slots.

``save`` pickles the method (its state table, schedule and the slots
of the flat API, ``_flat_slots``, or of a training loop's checkpoint,
``_train_slots``) with every tensor copied to the host.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from bigdl_tpu_torch.utils.config_capture import ConfigCaptured


def _map(f, *trees):
    """``f`` over matching leaves of tensors or lists/tuples of tensors."""
    if isinstance(trees[0], (list, tuple)):
        return [f(*leaves) for leaves in zip(*trees)]
    return f(*trees)


# ---------------------------------------------------------------------------
# Learning-rate schedules
# ---------------------------------------------------------------------------
class LearningRateSchedule(ConfigCaptured):
    def rate(self, method: "OptimMethod", state: Dict[str, Any]) -> float:
        raise NotImplementedError


class Default(LearningRateSchedule):
    """lr / (1 + (neval - 1) * learning_rate_decay)."""

    def rate(self, method, state):
        n = state.get("neval", 1) - 1
        return method.learning_rate / (1 + n * method.learning_rate_decay)


class Poly(LearningRateSchedule):
    """lr * (1 - n / max_iteration) ^ power, 0 from max_iteration on."""

    def __init__(self, power: float, max_iteration: int):
        self.power = power
        self.max_iteration = max_iteration

    def rate(self, method, state):
        n = state.get("neval", 1) - 1
        if n >= self.max_iteration:
            return 0.0
        return method.learning_rate * (1 - n / self.max_iteration) ** self.power


class Step(LearningRateSchedule):
    """lr * gamma ^ floor(n / step_size)."""

    def __init__(self, step_size: int, gamma: float):
        self.step_size = step_size
        self.gamma = gamma

    def rate(self, method, state):
        n = state.get("neval", 1) - 1
        return method.learning_rate * self.gamma ** (n // self.step_size)


class MultiStep(LearningRateSchedule):
    """lr * gamma ^ (number of step sizes reached)."""

    def __init__(self, step_sizes, gamma: float):
        self.step_sizes = list(step_sizes)
        self.gamma = gamma

    def rate(self, method, state):
        n = state.get("neval", 1) - 1
        k = sum(1 for s in self.step_sizes if n >= s)
        return method.learning_rate * self.gamma ** k


class EpochStep(LearningRateSchedule):
    """lr * gamma ^ floor((epoch - 1) / step_size)."""

    def __init__(self, step_size: int, gamma: float):
        self.step_size = step_size
        self.gamma = gamma

    def rate(self, method, state):
        e = state.get("epoch", 1)
        return method.learning_rate * self.gamma ** ((e - 1) // self.step_size)


class EpochDecay(LearningRateSchedule):
    """lr * 0.1 ^ decay_fn(epoch)."""

    def __init__(self, decay_fn):
        self.decay_fn = decay_fn

    def rate(self, method, state):
        e = state.get("epoch", 1)
        return method.learning_rate * 0.1 ** self.decay_fn(e)


class Exponential(LearningRateSchedule):
    """lr * decay_rate ^ (n / decay_step), floored with ``staircase``."""

    def __init__(self, decay_step: int, decay_rate: float,
                 staircase: bool = False):
        self.decay_step = decay_step
        self.decay_rate = decay_rate
        self.staircase = staircase

    def rate(self, method, state):
        n = state.get("neval", 1) - 1
        p = n / self.decay_step
        if self.staircase:
            p = math.floor(p)
        return method.learning_rate * self.decay_rate ** p


class Plateau(LearningRateSchedule):
    """Multiply the rate by ``factor`` when the monitored score has not
    improved by ``epsilon`` for ``patience`` epochs (one check per
    epoch), then wait ``cooldown`` epochs; never below ``min_lr``."""

    def __init__(self, monitor: str = "score", factor: float = 0.1,
                 patience: int = 10, mode: str = "min", epsilon: float = 1e-4,
                 cooldown: int = 0, min_lr: float = 0.0):
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.mode = mode
        self.epsilon = epsilon
        self.cooldown = cooldown
        self.min_lr = min_lr
        self._lr: Optional[float] = None
        self._best: Optional[float] = None
        self._wait = 0
        self._cooldown_left = 0
        self._last_epoch = -1

    def _improved(self, cur):
        if self._best is None:
            return True
        if self.mode == "min":
            return cur < self._best - self.epsilon
        return cur > self._best + self.epsilon

    def rate(self, method, state):
        if self._lr is None:
            self._lr = method.learning_rate
        cur = state.get(self.monitor)
        epoch = state.get("epoch", 1)
        if cur is not None and epoch != self._last_epoch:
            self._last_epoch = epoch
            if self._cooldown_left > 0:
                self._cooldown_left -= 1
                self._wait = 0
            if self._improved(cur):
                self._best = cur
                self._wait = 0
            elif self._cooldown_left <= 0:
                self._wait += 1
                if self._wait >= self.patience:
                    self._lr = max(self._lr * self.factor, self.min_lr)
                    self._cooldown_left = self.cooldown
                    self._wait = 0
        return self._lr


class Warmup(LearningRateSchedule):
    """lr + delta * n: a linear ramp, chained with SequentialSchedule."""

    def __init__(self, delta: float):
        self.delta = delta

    def rate(self, method, state):
        n = state.get("neval", 1) - 1
        return method.learning_rate + self.delta * n


class SequentialSchedule(LearningRateSchedule):
    """Schedules one after another, each for a number of iterations (the
    last one for ever); each sees ``neval`` and ``epoch`` counted from
    its own start."""

    def __init__(self, iteration_per_epoch: int = 1):
        self.schedules = []  # (schedule, n_iterations)
        self.iteration_per_epoch = iteration_per_epoch

    def add(self, schedule: LearningRateSchedule,
            max_iteration: int) -> "SequentialSchedule":
        self.schedules.append((schedule, max_iteration))
        return self

    def rate(self, method, state):
        n = state.get("neval", 1) - 1
        offset = 0
        for i, (sched, cnt) in enumerate(self.schedules):
            if n < offset + cnt or i == len(self.schedules) - 1:
                sub = dict(state)
                sub["neval"] = n - offset + 1
                sub["epoch"] = ((n - offset)
                                // max(self.iteration_per_epoch, 1) + 1)
                return sched.rate(method, sub)
            offset += cnt
        return method.learning_rate


class EpochSchedule(LearningRateSchedule):
    """Fixed rates over epoch ranges: ``regimes`` is a list of
    (start_epoch, end_epoch, lr); outside them the method's rate."""

    def __init__(self, regimes):
        self.regimes = list(regimes)

    def rate(self, method, state):
        e = state.get("epoch", 1)
        for start, end, lr in self.regimes:
            if start <= e <= end:
                return lr
        return method.learning_rate


class CosineDecay(LearningRateSchedule):
    """Cosine annealing from ``peak_lr`` (default: the method's rate) to
    ``min_lr`` over ``decay_iterations``."""

    def __init__(self, decay_iterations: int, min_lr: float = 0.0,
                 peak_lr: Optional[float] = None):
        if decay_iterations < 1:
            raise ValueError("decay_iterations must be >= 1")
        self.decay_iterations = decay_iterations
        self.min_lr = min_lr
        self.peak_lr = peak_lr

    def rate(self, method, state):
        n = min(state.get("neval", 1) - 1, self.decay_iterations)
        cos = 0.5 * (1.0 + math.cos(math.pi * n / self.decay_iterations))
        peak = self.peak_lr if self.peak_lr is not None \
            else method.learning_rate
        return self.min_lr + (peak - self.min_lr) * cos


class NaturalExp(LearningRateSchedule):
    """lr * exp(-gamma * floor(n / decay_step))."""

    def __init__(self, decay_step: int, gamma: float):
        self.decay_step = decay_step
        self.gamma = gamma

    def rate(self, method, state):
        n = state.get("neval", 1) - 1
        return method.learning_rate * math.exp(
            -self.gamma * (n // self.decay_step))


# ---------------------------------------------------------------------------
# Methods
# ---------------------------------------------------------------------------
class OptimMethod(ConfigCaptured):
    """Base: a functional ``step`` and a host-side state table (keys
    ``epoch``, ``neval``, ``score``, ... as in BigDL)."""

    def __init__(self, learning_rate: float = 1e-3):
        self.learning_rate = float(learning_rate)
        self.state: Dict[str, Any] = {"epoch": 1, "neval": 1}
        self.schedule: Optional[LearningRateSchedule] = None

    def init_slots(self, params) -> Any:
        """Per-parameter state (momentum buffers, ...)."""
        return {}

    def step(self, params, grads, slots, lr):
        """(new_params, new_slots); ``lr`` is the scheduled scalar."""
        raise NotImplementedError

    def get_current_rate(self) -> float:
        if self.schedule is not None:
            return self.schedule.rate(self, self.state)
        return self.learning_rate

    def get_learning_rate(self) -> float:
        return self.get_current_rate()

    def update_state(self, **kv) -> None:
        self.state.update(kv)

    # ------------------------------------------------ flat API (parity)
    def optimize(self, feval, x):
        """The reference's ``optimize(feval, parameter)`` on one flat
        tensor: ``feval(x) -> (loss, grad)``; returns (new x, [loss])."""
        loss, grad = feval(x)
        if not hasattr(self, "_flat_slots"):
            self._flat_slots = self.init_slots(x)
        lr = self.get_current_rate()
        x, self._flat_slots = self.step(x, grad, self._flat_slots, lr)
        self.state["neval"] = self.state.get("neval", 1) + 1
        return x, [float(loss)]

    # ------------------------------------------------------ persistence
    def save(self, path: str, overwrite: bool = False) -> "OptimMethod":
        from bigdl_tpu_torch.utils import file as bt_file

        bt_file.save(self, path, overwrite=overwrite)
        return self

    @staticmethod
    def load(path: str) -> "OptimMethod":
        """The method saved at ``path``; its slot tensors are on the host
        (the training loop moves them to the model's device)."""
        from bigdl_tpu_torch.utils import file as bt_file

        return bt_file.load(path)

    def clear_history(self) -> None:
        self.state = {"epoch": 1, "neval": 1}
        for name in ("_flat_slots", "_train_slots"):
            self.__dict__.pop(name, None)


def _apply_weight_decay(grads, params, wd: float):
    if wd:
        return _map(lambda g, p: g + wd * p, grads, params)
    return grads


class SGD(OptimMethod):
    """SGD with momentum, dampening (default: ``momentum``), nesterov,
    weight decay and a schedule (default :class:`Default`)."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0,
                 weight_decay: float = 0.0, momentum: float = 0.0,
                 dampening: Optional[float] = None, nesterov: bool = False,
                 learning_rate_schedule: Optional[LearningRateSchedule] = None):
        super().__init__(learning_rate)
        self.learning_rate_decay = float(learning_rate_decay)
        self.weight_decay = float(weight_decay)
        self.momentum = float(momentum)
        self.dampening = float(momentum if dampening is None else dampening)
        if nesterov and (momentum <= 0 or self.dampening != 0):
            raise ValueError("nesterov requires momentum > 0 and "
                             "dampening = 0")
        self.nesterov = nesterov
        self.schedule = learning_rate_schedule or Default()

    def init_slots(self, params):
        if self.momentum:
            return {"velocity": _map(torch.zeros_like, params)}
        return {}

    def step(self, params, grads, slots, lr):
        grads = _apply_weight_decay(grads, params, self.weight_decay)
        if not self.momentum:
            return _map(lambda p, g: p - lr * g, params, grads), slots
        v = _map(lambda vel, g: self.momentum * vel
                 + (1 - self.dampening) * g, slots["velocity"], grads)
        upd = (_map(lambda g, vel: g + self.momentum * vel, grads, v)
               if self.nesterov else v)
        return _map(lambda p, u: p - lr * u, params, upd), {"velocity": v}


class Adam(OptimMethod):
    """Adam with L2 weight decay added to the gradient; the step count
    ``t`` is an int32 tensor in the slots."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(learning_rate)
        self.learning_rate_decay = float(learning_rate_decay)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.weight_decay = float(weight_decay)
        self.schedule = Default()

    def init_slots(self, params):
        leaves = params if isinstance(params, (list, tuple)) else [params]
        return {"m": _map(torch.zeros_like, params),
                "v": _map(torch.zeros_like, params),
                "t": torch.zeros((), dtype=torch.int32,
                                 device=leaves[0].device if leaves
                                 else None)}

    def _adam(self, params, grads, slots, lr, weight_decay: float):
        grads = _apply_weight_decay(grads, params, weight_decay)
        t = slots["t"] + 1
        b1, b2 = self.beta1, self.beta2
        m = _map(lambda m_, g: b1 * m_ + (1 - b1) * g, slots["m"], grads)
        v = _map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, slots["v"], grads)
        tf = t.float()
        c1 = 1 - torch.pow(b1, tf)
        c2 = 1 - torch.pow(b2, tf)
        new = _map(lambda p, m_, v_: p - lr * (m_ / c1)
                   / (torch.sqrt(v_ / c2) + self.epsilon), params, m, v)
        return new, {"m": m, "v": v, "t": t}

    def step(self, params, grads, slots, lr):
        return self._adam(params, grads, slots, lr, self.weight_decay)


class AdamW(Adam):
    """Adam with decoupled weight decay: ``lr * weight_decay * p`` is
    taken from the parameter after the Adam update, not added to the
    gradient."""

    def step(self, params, grads, slots, lr):
        new, slots = self._adam(params, grads, slots, lr, 0.0)
        wd = self.weight_decay
        if wd:
            new = _map(lambda n, p: n - lr * wd * p, new, params)
        return new, slots


class Adagrad(OptimMethod):
    """Adagrad with L2 weight decay added to the gradient."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0,
                 weight_decay: float = 0.0, epsilon: float = 1e-10):
        super().__init__(learning_rate)
        self.learning_rate_decay = float(learning_rate_decay)
        self.weight_decay = float(weight_decay)
        self.epsilon = epsilon
        self.schedule = Default()

    def init_slots(self, params):
        return {"accum": _map(torch.zeros_like, params)}

    def step(self, params, grads, slots, lr):
        grads = _apply_weight_decay(grads, params, self.weight_decay)
        accum = _map(lambda a, g: a + g * g, slots["accum"], grads)
        new = _map(lambda p, g, a: p - lr * g / (torch.sqrt(a)
                                                 + self.epsilon),
                   params, grads, accum)
        return new, {"accum": accum}


class Adadelta(OptimMethod):
    """Adadelta: no learning rate (fixed at 1), ``decay_rate`` rho."""

    def __init__(self, decay_rate: float = 0.9, epsilon: float = 1e-10):
        super().__init__(1.0)
        self.rho = decay_rate
        self.epsilon = epsilon

    def init_slots(self, params):
        return {"accum": _map(torch.zeros_like, params),
                "accum_update": _map(torch.zeros_like, params)}

    def step(self, params, grads, slots, lr):
        rho, eps = self.rho, self.epsilon
        accum = _map(lambda a, g: rho * a + (1 - rho) * g * g,
                     slots["accum"], grads)
        delta = _map(lambda au, a, g: torch.sqrt(au + eps)
                     / torch.sqrt(a + eps) * g,
                     slots["accum_update"], accum, grads)
        accum_update = _map(lambda au, d: rho * au + (1 - rho) * d * d,
                            slots["accum_update"], delta)
        new = _map(lambda p, d: p - lr * d, params, delta)
        return new, {"accum": accum, "accum_update": accum_update}


class Adamax(OptimMethod):
    """Adamax: the infinity-norm Adam; ``t`` an int32 tensor slot."""

    def __init__(self, learning_rate: float = 2e-3, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-38):
        super().__init__(learning_rate)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def init_slots(self, params):
        leaves = params if isinstance(params, (list, tuple)) else [params]
        return {"m": _map(torch.zeros_like, params),
                "u": _map(torch.zeros_like, params),
                "t": torch.zeros((), dtype=torch.int32,
                                 device=leaves[0].device if leaves
                                 else None)}

    def step(self, params, grads, slots, lr):
        t = slots["t"] + 1
        b1, b2 = self.beta1, self.beta2
        m = _map(lambda m_, g: b1 * m_ + (1 - b1) * g, slots["m"], grads)
        u = _map(lambda u_, g: torch.maximum(b2 * u_, g.abs() + self.epsilon),
                 slots["u"], grads)
        c1 = 1 - torch.pow(b1, t.float())
        new = _map(lambda p, m_, u_: p - (lr / c1) * m_ / u_, params, m, u)
        return new, {"m": m, "u": u, "t": t}


class RMSprop(OptimMethod):
    """RMSprop: ``decay_rate`` rho over the squared gradients."""

    def __init__(self, learning_rate: float = 1e-2,
                 learning_rate_decay: float = 0.0, decay_rate: float = 0.99,
                 epsilon: float = 1e-8):
        super().__init__(learning_rate)
        self.learning_rate_decay = float(learning_rate_decay)
        self.rho = decay_rate
        self.epsilon = epsilon
        self.schedule = Default()

    def init_slots(self, params):
        return {"accum": _map(torch.zeros_like, params)}

    def step(self, params, grads, slots, lr):
        rho = self.rho
        accum = _map(lambda a, g: rho * a + (1 - rho) * g * g,
                     slots["accum"], grads)
        new = _map(lambda p, g, a: p - lr * g / (torch.sqrt(a)
                                                 + self.epsilon),
                   params, grads, accum)
        return new, {"accum": accum}


class Ftrl(OptimMethod):
    """Follow the regularized leader, with L1, L2 and L2-shrinkage
    strengths."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_power: float = -0.5,
                 initial_accumulator_value: float = 0.1,
                 l1_regularization_strength: float = 0.0,
                 l2_regularization_strength: float = 0.0,
                 l2_shrinkage_regularization_strength: float = 0.0):
        super().__init__(learning_rate)
        self.lr_power = learning_rate_power
        self.init_accum = initial_accumulator_value
        self.l1 = l1_regularization_strength
        self.l2 = l2_regularization_strength
        self.l2_shrinkage = l2_shrinkage_regularization_strength

    def init_slots(self, params):
        return {"accum": _map(lambda p: torch.full_like(p, self.init_accum),
                              params),
                "linear": _map(torch.zeros_like, params)}

    def step(self, params, grads, slots, lr):
        lp = self.lr_power

        def upd(p, g, a, lin):
            g_shrunk = g + 2 * self.l2_shrinkage * p
            new_a = a + g * g
            sigma = (new_a ** -lp - a ** -lp) / lr
            new_l = lin + g_shrunk - sigma * p
            quad = new_a ** -lp / lr + 2 * self.l2
            if self.l1 == 0.0:
                new_p = -new_l / quad
            else:
                new_p = (new_l.clamp(-self.l1, self.l1) - new_l) / quad
            return new_p, new_a, new_l

        outs = _map(upd, params, grads, slots["accum"], slots["linear"])
        if not isinstance(params, (list, tuple)):
            return outs[0], {"accum": outs[1], "linear": outs[2]}
        return ([o[0] for o in outs],
                {"accum": [o[1] for o in outs],
                 "linear": [o[2] for o in outs]})


class LBFGS(OptimMethod):
    """Limited-memory BFGS over the flat ``optimize(feval, x)`` API (a
    host loop: each iteration reads its dot products on the host), for
    small full-batch problems; the train step's ``step`` is plain
    gradient descent, as in the JAX package."""

    def __init__(self, max_iter: int = 20, max_eval: Optional[float] = None,
                 tolerance_fun: float = 1e-5, tolerance_x: float = 1e-9,
                 n_correction: int = 100, learning_rate: float = 1.0,
                 line_search: bool = False):
        super().__init__(learning_rate)
        self.max_iter = max_iter
        self.max_eval = max_eval if max_eval is not None else max_iter * 1.25
        self.tol_fun = tolerance_fun
        self.tol_x = tolerance_x
        self.n_correction = n_correction
        self.line_search = line_search

    def step(self, params, grads, slots, lr):
        return _map(lambda p, g: p - lr * g, params, grads), slots

    def optimize(self, feval, x):
        x = torch.as_tensor(x)
        loss, g = feval(x)
        losses = [float(loss)]
        old_dirs, old_steps = [], []
        hdiag = 1.0
        prev_g = g
        t = min(1.0, 1.0 / float(g.abs().sum() + 1e-10)) * self.learning_rate
        n_eval = 1
        for _ in range(self.max_iter):
            if float(g.abs().max()) <= 1e-10:
                break
            if old_dirs:  # two-loop recursion
                q = -g
                alphas = []
                rhos = [1.0 / float(torch.dot(yd, sd))
                        for yd, sd in zip(old_dirs, old_steps)]
                for i in range(len(old_dirs) - 1, -1, -1):
                    a = rhos[i] * float(torch.dot(old_steps[i], q))
                    alphas.append((i, a))
                    q = q - a * old_dirs[i]
                r = q * hdiag
                for i, a in reversed(alphas):
                    b = rhos[i] * float(torch.dot(old_dirs[i], r))
                    r = r + (a - b) * old_steps[i]
                d = r
            else:
                d = -g
            gtd = float(torch.dot(g, d))
            if gtd > -self.tol_x:
                break
            x_new = x + t * d
            new_loss, new_g = feval(x_new)
            n_eval += 1
            y = new_g - prev_g
            s = t * d
            ys = float(torch.dot(y, s))
            if ys > 1e-10:
                if len(old_dirs) == self.n_correction:
                    old_dirs.pop(0)
                    old_steps.pop(0)
                old_dirs.append(y)
                old_steps.append(s)
                hdiag = ys / float(torch.dot(y, y))
            if abs(float(new_loss) - losses[-1]) < self.tol_fun:
                x, g = x_new, new_g
                losses.append(float(new_loss))
                break
            x, g, prev_g = x_new, new_g, new_g
            losses.append(float(new_loss))
            t = self.learning_rate
            if n_eval > self.max_eval:
                break
        self.state["neval"] = self.state.get("neval", 1) + 1
        return x, losses


class ParallelAdam(Adam):
    """Adam: the reference shards the update across threads; one device
    update does that work here, as in the JAX package."""
