"""ddb_tpu_torch: the PyTorch/CUDA port of ddb_tpu.

The SQL front end (parser, binder, optimizer, catalog) is ddb_tpu's,
carried over unchanged; execution runs eagerly in torch on an explicit
device: scans, filters, projections, aggregates, joins of every kind
(ops/join.py), UNION ALL, order, limit and distinct.  DDL, DML,
transactions and indexes run as in ddb_tpu (api.py, storage/dml.py):
predicates on the device, mutations on the host arrays, after which the
table's cached device batches are dropped.  Three hand-written
CUDA kernels stand in for the TPU kernels of ddb_tpu: the fused TPC-H Q1
and Q6 aggregates (ops/fused_agg.py, csrc/fused_agg.cu) and the
compare-exchange stages of a bitonic network (ops/cmpx.py,
csrc/cmpx.cu).  Nothing here imports JAX.
"""

from .api import Connection, QueryResult, connect  # noqa: F401

__version__ = "0.1.0"
