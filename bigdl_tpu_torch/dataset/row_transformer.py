"""Tabular row -> Table-of-tensors pipeline (port of
``bigdl_tpu/dataset/row_transformer.py``; the Table is the port's).

Reference: dataset/datamining/RowTransformer.scala:44 — a container of
RowTransformSchemas: each schema selects fields of a Row (by name or
index) and emits one tensor under its schemaKey; the transformer yields a
Table keyed by schemaKey. Factories: ``atomic`` (one key per field),
``numeric`` (all named fields into one numeric vector),
``atomic_with_numeric`` (mix).

Rows are dicts / pandas Series / sequences; output tensors are numpy
(host data pipeline)."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.dataset.transformer import Transformer
from bigdl_tpu_torch.utils.table import Table


class RowTransformSchema:
    """≙ RowTransformSchema: select fields, produce one tensor."""

    def __init__(self, schema_key: str,
                 field_names: Sequence[str] = (),
                 indices: Sequence[int] = (),
                 transform: Optional[Callable] = None):
        if bool(field_names) == bool(indices) and field_names:
            raise ValueError("give field_names OR indices, not both")
        self.schema_key = schema_key
        self.field_names = list(field_names)
        self.indices = list(indices)
        self._transform = transform

    def _select(self, row):
        if self.field_names:
            return [row[f] for f in self.field_names]
        if self.indices:
            vals = list(row.values()) if isinstance(row, dict) else list(row)
            return [vals[i] for i in self.indices]
        return list(row.values()) if isinstance(row, dict) else list(row)

    def transform(self, row) -> np.ndarray:
        vals = self._select(row)
        if self._transform is not None:
            return np.asarray(self._transform(vals))
        return np.asarray(vals, np.float32)


class RowTransformer(Transformer):
    """≙ RowTransformer.scala:44: Row -> Table{schemaKey: tensor}."""

    def __init__(self, schemas: Sequence[RowTransformSchema],
                 row_size: Optional[int] = None):
        keys = [s.schema_key for s in schemas]
        if len(set(keys)) != len(keys):
            raise ValueError(f"replicated schemaKey in {keys}")
        self.schemas = list(schemas)
        self.row_size = row_size
        if row_size is not None:
            for s in self.schemas:
                if any(i < 0 or i >= row_size for i in s.indices):
                    raise ValueError(
                        f"indices out of bound for rowSize {row_size}: "
                        f"{s.indices}")

    def transform_row(self, row) -> Table:
        t = Table()
        for s in self.schemas:
            t[s.schema_key] = s.transform(row)
        return t

    def __call__(self, it):
        for row in it:
            yield self.transform_row(row)

    # ---------------------------------------------------------- factories
    @staticmethod
    def atomic(field_names: Sequence[str] = None,
               indices: Sequence[int] = None,
               row_size: Optional[int] = None) -> "RowTransformer":
        """One schemaKey per field (≙ RowTransformer.atomic)."""
        if field_names:
            schemas = [RowTransformSchema(f, field_names=[f])
                       for f in field_names]
        else:
            schemas = [RowTransformSchema(str(i), indices=[i])
                       for i in (indices or [])]
        return RowTransformer(schemas, row_size)

    @staticmethod
    def numeric(field_names: Sequence[str],
                schema_key: str = "all") -> "RowTransformer":
        """All named fields into ONE numeric vector (≙ .numeric)."""
        return RowTransformer(
            [RowTransformSchema(schema_key, field_names=field_names)])

    @staticmethod
    def atomic_with_numeric(atomic_fields: Sequence[str],
                            numeric_fields: Sequence[str],
                            numeric_key: str = "numeric") -> "RowTransformer":
        schemas = [RowTransformSchema(f, field_names=[f])
                   for f in atomic_fields]
        schemas.append(RowTransformSchema(numeric_key,
                                          field_names=numeric_fields))
        return RowTransformer(schemas)
