"""Config/flag system: the ``bigdl.*`` property tiers as ``BIGDL_TPU_*``
environment variables (a copy of ``bigdl_tpu/utils/config.py``, which
imports no framework; the port keeps its own so it never imports the JAX
package).

Three tiers, highest first: an in-process override (``set_property``, the
counterpart of ``System.setProperty``), the environment variable
(``bigdl.failure.retryTimes`` -> ``BIGDL_TPU_FAILURE_RETRY_TIMES``: dots
to underscores, camelCase to SNAKE), then ``DEFAULTS``. The
``DistriOptimizer`` reads ``bigdl.log.interval``,
``bigdl.failure.retryTimes`` and ``bigdl.failure.retryTimeInterval``
through it.
"""

from __future__ import annotations

import os
import re
from typing import Callable, Dict, Optional, TypeVar

T = TypeVar("T")

_overrides: Dict[str, str] = {}

#: Known properties and defaults (the reference's documented set; values are
#: strings exactly as System.getProperty returns them).
DEFAULTS = {
    "bigdl.engineType": "bfloat16",          # ≙ MklBlas/MklDnn → dtype policy
    "bigdl.localMode": "false",
    "bigdl.coreNumber": "",                  # ≙ local device override
    "bigdl.check.singleton": "false",
    "bigdl.failure.retryTimes": "5",         # DistriOptimizer.scala:977
    "bigdl.failure.retryTimeInterval": "120",  # seconds; :978
    "bigdl.Parameter.syncPoolSize": "4",
    "bigdl.Parameter.computePoolSize": "",
    "bigdl.utils.Engine.defaultPoolSize": "",
    "bigdl.log.interval": "1",               # TPU-native: host-sync/log cadence
}


def to_env_name(prop: str) -> str:
    """``bigdl.failure.retryTimes`` → ``BIGDL_TPU_FAILURE_RETRY_TIMES``."""
    body = prop[len("bigdl."):] if prop.startswith("bigdl.") else prop
    body = re.sub(r"([a-z0-9])([A-Z])", r"\1_\2", body.replace(".", "_"))
    return "BIGDL_TPU_" + body.upper()


def get_property(prop: str, default: Optional[str] = None) -> Optional[str]:
    """Resolution order: in-process override → env var → DEFAULTS → default."""
    if prop in _overrides:
        return _overrides[prop]
    env = os.environ.get(to_env_name(prop))
    if env is not None:
        return env
    if prop in DEFAULTS and DEFAULTS[prop] != "":
        return DEFAULTS[prop]
    return default


def set_property(prop: str, value) -> None:
    """≙ System.setProperty (in-process tier; wins over env)."""
    _overrides[prop] = str(value)


def clear_property(prop: str) -> None:
    _overrides.pop(prop, None)


def _typed(prop: str, default: T, cast: Callable[[str], T]) -> T:
    raw = get_property(prop)
    if raw is None or raw == "":
        return default
    try:
        return cast(raw)
    except (TypeError, ValueError):
        return default


def get_int(prop: str, default: int = 0) -> int:
    return _typed(prop, default, int)


def get_float(prop: str, default: float = 0.0) -> float:
    return _typed(prop, default, float)


def get_bool(prop: str, default: bool = False) -> bool:
    return _typed(prop, default, lambda s: s.strip().lower() in ("1", "true", "yes"))
