"""clickhouse_tpu — a vectorized query-execution engine on JAX/XLA.

Built from scratch in JAX/XLA with the capabilities of the reference
column-oriented OLAP DBMS (ClickHouse).  See
SURVEY.md for the structural analysis and the design translations.
"""
__version__ = "0.1.0"

import jax as _jax

# OLAP data is Int64/UInt64-heavy (reference: ColumnVector<UInt64> everywhere);
# JAX's 32-bit default would silently truncate, so x64 is enabled at import.
_jax.config.update("jax_enable_x64", True)

from .core import dtypes, Block, Column, Settings


def connect(**kwargs):
    """Create an in-process session (the `clickhouse-local` analog,
    reference: programs/local/LocalServer.cpp)."""
    from .exec.session import Session
    return Session(**kwargs)
