"""Block: the unit of processing — a set of equal-capacity columns.

Device-array analog of the reference's Block/Chunk pair (src/Core/Block.h:30,
src/Processors/Chunk.h:56).  One structure serves both roles:

* ``columns`` — ordered name -> Column (names+types like Block);
* ``num_rows`` — number of valid leading rows.  May be a host int (when known
  statically) or a traced JAX scalar (when produced by a data-dependent
  operator such as filter — the reference reallocates instead; we keep the
  padded capacity and a count, per SURVEY.md §7 "Dynamic shapes").

Rows [num_rows, capacity) are padding and must be masked by consumers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from . import dtypes as dt
from .column import Column, column_from_numpy, pad_to

__all__ = ["Block", "block_from_pydict"]

Count = Union[int, jax.Array]


@dataclasses.dataclass
class Block:
    columns: Dict[str, Column]
    num_rows: Count

    # -- shape ---------------------------------------------------------------
    @property
    def capacity(self) -> int:
        for c in self.columns.values():
            return c.capacity
        return 0

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    @property
    def names(self) -> List[str]:
        return list(self.columns.keys())

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    def __getitem__(self, name: str) -> Column:
        return self.columns[name]

    def row_count_static(self) -> int:
        """Host-side row count; synchronizes if the count lives on device."""
        if isinstance(self.num_rows, (int, np.integer)):
            return int(self.num_rows)
        return int(jax.device_get(self.num_rows))

    def row_mask(self) -> jax.Array:
        """Bool mask over [0, capacity): True for valid rows."""
        idx = jnp.arange(self.capacity)
        return idx < jnp.asarray(self.num_rows, dtype=idx.dtype)

    # -- construction --------------------------------------------------------
    def with_columns(self, columns: Dict[str, Column],
                     num_rows: Optional[Count] = None) -> "Block":
        return Block(columns, self.num_rows if num_rows is None else num_rows)

    def select(self, names: Iterable[str]) -> "Block":
        return Block({n: self.columns[n] for n in names}, self.num_rows)

    def rename(self, mapping: Dict[str, str]) -> "Block":
        return Block({mapping.get(n, n): c for n, c in self.columns.items()},
                     self.num_rows)

    # -- host transfer -------------------------------------------------------
    def to_pydict(self) -> Dict[str, np.ndarray]:
        n = self.row_count_static()
        return {name: col.to_numpy(n) for name, col in self.columns.items()}

    def to_pandas(self):
        import pandas as pd
        return pd.DataFrame(self.to_pydict())

    def to_rows(self) -> List[Tuple]:
        d = self.to_pydict()
        cols = list(d.values())
        return list(zip(*cols)) if cols else []

    def schema(self) -> List[Tuple[str, dt.DType]]:
        return [(n, c.dtype) for n, c in self.columns.items()]


def block_from_pydict(data: Dict[str, np.ndarray],
                      types: Optional[Dict[str, dt.DType]] = None,
                      capacity: Optional[int] = None) -> Block:
    lengths = {len(np.asarray(v)) for v in data.values()}
    if len(lengths) > 1:
        raise ValueError(f"Unequal column lengths: {lengths}")
    n = lengths.pop() if lengths else 0
    cap = capacity or pad_to(n)
    cols = {}
    for name, vals in data.items():
        t = types.get(name) if types else None
        cols[name] = column_from_numpy(np.asarray(vals), t, capacity=cap)
    return Block(cols, n)
