"""The benchmark of ddb_tpu_torch: one cell of BENCHMARK.json a run.

    python3 -m portbench.run --workload <cell> --seed <n>
        --seconds <s> --trace <0|1>

A cell names a configuration (configs/<name>.json: the deployment, its
generator and its reference) and a traffic mix (traffic/<name>.json: the
query templates, their parameter draws and the bytes each must move).
Per-layer metrics are readers in metrics/<name>.py over the traced run.
Nothing here imports jax or ddb_tpu; reference/ imports no ddb_tpu_torch.
"""
