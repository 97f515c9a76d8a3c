"""Composable training triggers (a copy of ``bigdl_tpu/optim/trigger.py``,
which needs no framework).

Predicates over the optimizer's state table that drive the end of
training and the validation cadence. The state keys they read
(``epoch``, ``neval``, ``Loss``, ``score``) are the JAX package's.
"""

from __future__ import annotations


class Trigger:
    def __call__(self, state) -> bool:
        raise NotImplementedError

    # combinators (reference: Trigger.and/or)
    def and_(self, *others: "Trigger") -> "Trigger":
        return _And([self, *others])

    def or_(self, *others: "Trigger") -> "Trigger":
        return _Or([self, *others])

    # ------------------------------------------------------------- factories
    @staticmethod
    def every_epoch() -> "Trigger":
        return _EveryEpoch()

    @staticmethod
    def several_iteration(interval: int) -> "Trigger":
        return _SeveralIteration(interval)

    @staticmethod
    def max_epoch(n: int) -> "Trigger":
        return _MaxEpoch(n)

    @staticmethod
    def max_iteration(n: int) -> "Trigger":
        return _MaxIteration(n)

    @staticmethod
    def max_score(s: float) -> "Trigger":
        return _MaxScore(s)

    @staticmethod
    def min_loss(l: float) -> "Trigger":
        return _MinLoss(l)


class _EveryEpoch(Trigger):
    """Fires on epoch boundary (epoch increments past what we last saw)."""

    def __init__(self):
        self._last = 1

    def __call__(self, state):
        if state["epoch"] > self._last:
            self._last = state["epoch"]
            return True
        return False


class _SeveralIteration(Trigger):
    def __init__(self, interval: int):
        self.interval = int(interval)

    def __call__(self, state):
        return state["neval"] % self.interval == 0


class _MaxEpoch(Trigger):
    def __init__(self, n: int):
        self.n = int(n)

    def __call__(self, state):
        return state["epoch"] > self.n


class _MaxIteration(Trigger):
    def __init__(self, n: int):
        self.n = int(n)

    def __call__(self, state):
        return state["neval"] > self.n


class _MaxScore(Trigger):
    def __init__(self, s: float):
        self.s = float(s)

    def __call__(self, state):
        return state.get("score") is not None and state["score"] > self.s


class _MinLoss(Trigger):
    def __init__(self, l: float):
        self.l = float(l)

    def __call__(self, state):
        return state.get("Loss") is not None and state["Loss"] < self.l


class _And(Trigger):
    def __init__(self, triggers):
        self.triggers = list(triggers)

    def __call__(self, state):
        return all(t(state) for t in self.triggers)


class _Or(Trigger):
    def __init__(self, triggers):
        self.triggers = list(triggers)

    def __call__(self, state):
        return any(t(state) for t in self.triggers)
