"""Torch-style activity Table (port of ``bigdl_tpu/utils/table.py``).

The part that ``ConcatTable``, ``CAddTable`` and ``MiniBatch`` need: a
key -> value container whose positional entries take 1-based integer
keys, iterated in insertion order. The JAX package registers its Table
as a pytree; PyTorch has no such registry to join, so this one is a
plain container (the list/insert/remove/equality helpers are not
ported).
"""

from __future__ import annotations


class Table:
    def __init__(self, *args, **kwargs):
        self._state = {i + 1: v for i, v in enumerate(args)}
        self._state.update(kwargs)

    def __getitem__(self, key):
        return self._state[key]

    def __setitem__(self, key, value):
        self._state[key] = value

    def __contains__(self, key):
        return key in self._state

    def __len__(self):
        return len(self._state)

    def __iter__(self):
        return iter(self._state.values())

    def keys(self):
        return self._state.keys()

    def values(self):
        return self._state.values()

    def items(self):
        return self._state.items()

    def get(self, key, default=None):
        return self._state.get(key, default)

    def __repr__(self):
        items = ", ".join(f"{k}: {type(v).__name__}"
                          for k, v in self._state.items())
        return f"Table({items})"


def T(*args, **kwargs) -> Table:
    """Factory mirroring the reference's ``T()``."""
    return Table(*args, **kwargs)
