"""The reference's own test files run against the port by copy
(ddb_tpu_torch/testing/refsuite.py).  Every copy
tests/test_torch_ref_<name>.py must equal refsuite's rewrite of
tests/test_<name>.py byte for byte; the rewrite is the import rule, the
device routing of connect() and Connection(), and the hunks named in
refsuite.HUNKS, nothing else."""

import os
import re

import pytest

from ddb_tpu_torch.testing import refsuite

_TESTS = os.path.dirname(os.path.abspath(__file__))


def _read(name):
    with open(os.path.join(_TESTS, name), "rb") as f:
        return f.read().decode()


@pytest.mark.parametrize("name", refsuite.FILES)
def test_copy_equals_the_rewrite_of_its_reference_file(name):
    assert _read(f"test_torch_ref_{name}.py") == refsuite.rewrite(
        name, _read(f"test_{name}.py"))


def test_every_reference_file_is_copied_or_left_out_with_a_reason():
    ref = sorted(f[len("test_"):-len(".py")] for f in os.listdir(_TESTS)
                 if re.fullmatch(r"test_\w+\.py", f)
                 and not f.startswith("test_torch_"))
    assert not set(refsuite.FILES) & set(refsuite.LEFT_OUT)
    assert sorted(refsuite.FILES + tuple(refsuite.LEFT_OUT)) == ref
    assert all(refsuite.LEFT_OUT.values())
    copies = sorted(f for f in os.listdir(_TESTS)
                    if re.fullmatch(r"test_torch_ref_\w+\.py", f)
                    and f != "test_torch_ref_copy.py")
    assert copies == sorted(f"test_torch_ref_{n}.py" for n in refsuite.FILES)


_HUNKS = [(name, h.name) for name, hs in sorted(refsuite.HUNKS.items())
          for h in hs]


@pytest.mark.parametrize("name, hunk", _HUNKS)
def test_each_hunk_is_named_and_applies_as_counted(name, hunk):
    h = {x.name: x for x in refsuite.HUNKS[name]}[hunk]
    assert h.name and h.old != h.new
    generic = refsuite._generic(_read(f"test_{name}.py"))
    assert generic.count(h.old) == h.count
    copy = _read(f"test_torch_ref_{name}.py")
    if h.new:
        assert h.new in copy


def test_the_hunks_name_copied_files_only_and_no_hunk_twice():
    assert set(refsuite.HUNKS) <= set(refsuite.FILES)
    for name, hunks in refsuite.HUNKS.items():
        names = [h.name for h in hunks]
        assert len(names) == len(set(names)), name


_MARKS = r"\bskip\w*|\bxfail\b|\bslow\b|\bapprox\b|\brel=|\babs="


@pytest.mark.parametrize("name", refsuite.FILES)
def test_no_copy_skips_marks_or_loosens_more_than_its_reference(name):
    ref, copy = _read(f"test_{name}.py"), _read(f"test_torch_ref_{name}.py")
    for pattern in (_MARKS, r"<\s*[\d.e-]+", r"pytest\.mark\.\w+"):
        assert sorted(re.findall(pattern, copy)) == \
            sorted(re.findall(pattern, ref)), (name, pattern)


@pytest.mark.parametrize("name", refsuite.FILES)
def test_copy_imports_neither_jax_nor_the_reference(name):
    copy = _read(f"test_torch_ref_{name}.py")
    assert not re.search(r"(?m)^\s*(import|from) (jax|jaxlib|ddb_tpu)\b(?!_)",
                         copy)
    # every connection is made through refsuite, on its device
    assert not re.search(r"ddb_tpu_torch\.connect\(|[^.\w]connect\(\)", copy)
    assert "import Connection\n" not in copy.replace(
        "from ddb_tpu_torch.testing.refsuite import Connection\n", "")


def test_the_device_is_the_cpu_unless_named(monkeypatch):
    import torch
    monkeypatch.delenv(refsuite.DEVICE_ENV, raising=False)
    assert refsuite.device() == torch.device("cpu")
    before = refsuite.OPENED["cpu"]
    con = refsuite.connect()
    assert con.device == torch.device("cpu")
    assert refsuite.Connection().device == torch.device("cpu")
    assert refsuite.OPENED["cpu"] == before + 2
    if not torch.cuda.is_available():
        # the card without CUDA raises; nothing falls back to the CPU
        monkeypatch.setenv(refsuite.DEVICE_ENV, "cuda")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            refsuite.connect()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            refsuite.Connection()


def test_the_report_holds_connections_and_the_peak(tmp_path):
    path = tmp_path / "report.json"
    refsuite._report(str(path))
    import json
    got = json.loads(path.read_text())
    assert set(got) == {"connections", "peak_bytes"}
    assert got["connections"] == dict(refsuite.OPENED)
