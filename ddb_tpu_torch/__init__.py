"""ddb_tpu_torch: the PyTorch/CUDA port of ddb_tpu.

The SQL front end (parser, binder, optimizer, catalog) is carried over
from ddb_tpu unchanged; execution runs eagerly in torch on an explicit
device, and the fused TPC-H aggregates run as hand-written CUDA kernels
(ops/fused_agg.py, csrc/fused_agg.cu).  Nothing here imports JAX.
"""

from .api import Connection, QueryResult, connect  # noqa: F401

__version__ = "0.1.0"
