"""The port's serving examples (``examples/torch_*.py``) on the CPU at
``reduced()`` size, beside the reference examples they port.

Each example's ``main`` runs with ``--device cpu --reduced`` and prints the
reference example's lines: ``examples/torch_serve_resident_claims.py``
prints exactly the reference's lines after its model header (every line is
a claim state, gate verdict, attribution or routing decision, none a
token), ``examples/torch_quickstart.py`` the reference's lines apart from
the generated tokens (the port draws its weights from ``torch.Generator``
seed 0), and ``examples/torch_conformance_audit.py`` the lowering matrix
with the port's runtime the only ``native_sound`` backend, writing only
under the directory it is given.
"""
import contextlib
import importlib.util
import io
import re
from pathlib import Path

import pytest
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]


def _main(path, argv=None):
    """Run ``path``'s ``main(argv)`` and return its standard output."""
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main(argv) if argv is not None else mod.main()
    return buf.getvalue().splitlines()


def test_quickstart_prints_the_reference_lines():
    got = _main(ROOT / "examples" / "torch_quickstart.py", ["--device", "cpu", "--reduced"])
    want = _main(ROOT / "examples" / "quickstart.py")
    assert got[0].startswith("model qwen3-1.7b: 2 layers on cpu")
    tokens = re.compile(r"output=\[[^\]]*\]")
    assert [tokens.sub("output=[..]", line) for line in got[1:]] == [
        tokens.sub("output=[..]", line) for line in want]
    assert any(line.startswith("witness path A: passed=True") for line in got)


def test_serve_resident_claims_prints_the_reference_lines():
    got = _main(ROOT / "examples" / "torch_serve_resident_claims.py",
                ["--device", "cpu", "--reduced"])
    want = _main(ROOT / "examples" / "serve_resident_claims.py")
    assert got[0].startswith("model qwen3-1.7b: 2 layers on cpu")
    assert got[2:] == want
    assert "refusal: blocking_claim_ids=['claim-0000']" in got
    assert sum(line.startswith("gate:    True") for line in got) == 1


def test_conformance_audit_writes_only_where_told(tmp_path):
    committed = ROOT / "src" / "repro_torch" / "core" / "data" / "descriptors" / \
        "repro_torch_native.json"
    before = committed.read_bytes()
    got = _main(ROOT / "examples" / "torch_conformance_audit.py",
                ["--device", "cpu", "--reduced", "--out-dir", str(tmp_path)])
    assert committed.read_bytes() == before
    assert got[0] == ("regenerated native descriptor from live conformance traces: "
                      f"{tmp_path / 'repro_torch_native.json'}")
    native = [line for line in got if line.rstrip().endswith("-> native_sound")]
    assert len(native) == 7 and all(line.startswith("repro-torch-native") for line in native)
    assert any(re.match(r"\d+ rows; native_sound=7 \(this runtime\)", line) for line in got)
    assert {p.name for p in tmp_path.iterdir()} >= {"repro_torch_native.json",
                                                     "lowering-matrix.md", "offloadable.json"}


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_serve_resident_claims",
                                  "torch_conformance_audit"])
def test_examples_default_to_the_card(name, monkeypatch):
    """Without ``--device`` an example runs on the card, and raises where
    there is none (no quiet CPU fallback)."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _main(ROOT / "examples" / f"{name}.py", [])
