"""Constructor-config capture for serialization (a copy of
``bigdl_tpu/utils/config_capture.py``; the port keeps its own).

The reference serializes any layer by reflecting over its case-class
constructor (utils/serializer/ModuleSerializer.scala:34-118). The Python
analog: every subclass of an instrumented base records the (class, args,
kwargs) of its outermost ``__init__`` call on the instance, so the
serializer can re-create it with the same configuration. The record is
set with ``object.__setattr__``, so on a ``torch.nn.Module`` it is made
before ``torch.nn.Module.__init__`` runs.
"""

from __future__ import annotations

import functools

_SENTINEL = "_init_config"


def capture_init(cls) -> None:
    """Wrap cls.__init__ (if defined by cls itself) to record the outermost
    constructor call as ``self._init_config = (args, kwargs)``. Call from
    ``__init_subclass__`` of a base class to instrument a hierarchy."""
    orig = cls.__dict__.get("__init__")
    if orig is None or getattr(orig, "_captures_config", False):
        return

    @functools.wraps(orig)
    def wrapper(self, *args, **kwargs):
        if not hasattr(self, _SENTINEL):
            object.__setattr__(self, _SENTINEL, (args, kwargs))
        orig(self, *args, **kwargs)

    wrapper._captures_config = True
    cls.__init__ = wrapper


def get_init_config(obj):
    """(args, kwargs) of the outermost constructor call, or ((), {})."""
    return getattr(obj, _SENTINEL, ((), {}))


class ConfigCaptured:
    """Mixin: every subclass records its constructor args."""

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        capture_init(cls)
