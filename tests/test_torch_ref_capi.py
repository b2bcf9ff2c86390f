# Generated from tests/test_capi.py by ddb_tpu_torch/testing/refsuite.py
# (python -m ddb_tpu_torch.testing.refsuite capi); do not edit.
"""C API: build the native library + smoke client and run it.

Covers the reference's C API capability bar (reference:
src/include/duckdb.h surface, src/main/capi/) — open/connect/query/
typed value reads/prepared statements/appender from a real C program.
"""

from ddb_tpu_torch.testing import refsuite
import os
import shutil
import subprocess

import pytest

from ddb_tpu_torch import capi


@pytest.mark.skipif(shutil.which("cc") is None,
                    reason="C toolchain unavailable")
def test_capi_smoke():
    native = str(capi.build().dir)
    env = capi.child_env(str(refsuite.device()))
    r = subprocess.run([os.path.join(native, "capi_smoke")], cwd=native,
                       capture_output=True, text=True, env=env,
                       timeout=600)
    assert r.returncode == 0, (r.stdout + r.stderr)[-2000:]
    assert "capi smoke: OK" in r.stdout


@pytest.mark.skipif(shutil.which("cc") is None,
                    reason="C toolchain unavailable")
def test_adbc_smoke():
    # ADBC driver shim: ArrowArrayStream over the columnar export
    # (reference: src/common/adbc/ driver + adbc.h spec)
    native = str(capi.build().dir)
    env = capi.child_env(str(refsuite.device()))
    r = subprocess.run([os.path.join(native, "adbc_smoke")], cwd=native,
                       capture_output=True, text=True, env=env,
                       timeout=600)
    assert r.returncode == 0, (r.stdout + r.stderr)[-2000:]
    assert "adbc smoke: OK" in r.stdout
