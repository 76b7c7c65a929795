"""Device operator kernels (the IColumn vectorized-primitive layer).

Every operator here is plain `jax.numpy` / `lax`, compiled by XLA.  The hot
primitives are (a) streaming masked reductions (filter+count), which XLA
fuses into one pass over the column, (b) large multi-operand sorts
(`lax.sort`), and (c) probe gathers, which are bound by memory latency.  A
hand-written kernel enters only for a primitive that is on a measured hot
path and that XLA demonstrably schedules far from the device's roofline.
"""
from . import hash_ops, filter_ops, agg_ops, sort_ops, join_ops
