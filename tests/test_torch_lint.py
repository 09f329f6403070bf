"""The port's claim-lifecycle linter (``repro_torch.analysis``).

The JAX package's ``tests/test_lint.py`` catalogue, rewritten to torch
idioms: every rule gets small source fixtures that MUST trip it (violating)
and fixtures that MUST pass it (conforming).  On top of the catalogue:

  - the port's real tree lints clean and every suppression carries a reason;
  - the tamper test, suppression semantics, strict-CLI exit codes, the
    default report path and the report's shape;
  - parity: for the rules both linters share (emit-site, pin-balance,
    fail-closed-except, metric-drift, nondeterminism), the port's linter and
    the JAX package's ``repro.analysis.lint.lint_paths`` give the same
    (rule, line, suppressed) findings on the same framework-neutral sources;
  - the runtime half of the one-schema/two-layers contract, against the
    port's ``EventLog``.
"""
import json
import os
import subprocess
import sys
import textwrap
from dataclasses import dataclass
from pathlib import Path
from typing import List

import pytest

from repro.analysis.lint import lint_paths as jax_lint_paths
from repro_torch.analysis.framework import Finding
from repro_torch.analysis.lint import ALL_RULES, DEFAULT_REPORT, lint_paths
from repro_torch.analysis.lint import main as lint_main
from repro_torch.core.events import ALL_EVENT_NAMES, PAYLOAD_SCHEMA, EventLog

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch"
SHARED_RULES = ("emit-site", "pin-balance", "fail-closed-except", "metric-drift", "nondeterminism")


@dataclass(frozen=True)
class Case:
    rule: str
    name: str
    filename: str  # controls module_stem and the serving/, kernels/, models/ scopes
    code: str
    violating: bool
    neutral: bool = True  # no torch idiom: the JAX linter judges it alike


CASES = [
    # ---------------------------------------------------------- emit-site
    Case("emit-site", "non_boundary_module", "helper.py", """
        def note(log):
            log.emit("stage_latency", stage="prefill", seconds=0.1)
        """, violating=True),
    Case("emit-site", "emit_in_a_model", "models/transformer.py", """
        def layer(log, x):
            log.emit("stage_latency", stage="prefill", seconds=0.1)
            return x
        """, violating=True),
    Case("emit-site", "missing_required_payload", "core_engine.py", """
        def note(log):
            log.emit("stage_latency", stage="prefill")
        """, violating=True),
    Case("emit-site", "unknown_event_name", "core_engine.py", """
        def note(log):
            log.emit("totally_unknown_event")
        """, violating=True),
    Case("emit-site", "dynamic_event_name", "core_engine.py", """
        def note(log, name):
            log.emit(name, stage="prefill", seconds=0.1)
        """, violating=True),
    Case("emit-site", "undeclared_payload_key", "core_engine.py", """
        def note(log):
            log.emit("stage_latency", stage="prefill", seconds=0.1, color="red")
        """, violating=True),
    Case("emit-site", "direct_event_construction", "engine.py", """
        def note():
            return Event(0, 0.0, "stage_latency", {})
        """, violating=True),
    Case("emit-site", "boundary_full_payload", "core_engine.py", """
        def note(log):
            log.emit("stage_latency", request_id="r1", stage="prefill", seconds=0.5)
        """, violating=False),
    Case("emit-site", "snapshot_engine_is_a_boundary", "snapshot_engine.py", """
        def note(log):
            log.emit("stage_latency", request_id="r1", stage="restore", seconds=0.5)
        """, violating=False),
    # -------------------------------------------------------- pin-balance
    Case("pin-balance", "pin_without_exception_unwind", "helper.py", """
        def hold(blocks, work):
            pin_chain(blocks)
            work(blocks)
        """, violating=True),
    Case("pin-balance", "raw_ref_twiddle", "helper.py", """
        def bump(blk):
            blk.ref += 1
        """, violating=True),
    Case("pin-balance", "pin_with_finally_unwind", "helper.py", """
        def hold(blocks, work):
            pin_chain(blocks)
            try:
                work(blocks)
            finally:
                unpin_chain(blocks)
        """, violating=False),
    Case("pin-balance", "pin_with_except_unwind", "helper.py", """
        def hold(blocks, work):
            pin_chain(blocks)
            try:
                work(blocks)
            except Exception:
                unpin_chain(blocks)
                raise
        """, violating=False),
    Case("pin-balance", "ref_inside_kv_cache", "kv_cache.py", """
        def bump(blk):
            blk.ref += 1
        """, violating=False),
    # ------------------------------------------------- fail-closed-except
    Case("fail-closed-except", "bare_swallow", "serving/handler.py", """
        def step(risky):
            try:
                risky()
            except Exception:
                pass
        """, violating=True),
    Case("fail-closed-except", "logged_but_swallowed", "serving/handler.py", """
        def step(risky, errors):
            try:
                risky()
            except ValueError as exc:
                errors.append(str(exc))
        """, violating=True),
    Case("fail-closed-except", "kernel_wrapper_falls_back_to_plain", "kernels/attention.py", """
        import torch

        def attention(q, k, v):
            try:
                return _launch(q, k, v)
            except RuntimeError:
                return torch.softmax(q @ k.transpose(-1, -2), -1) @ v
        """, violating=True, neutral=False),
    Case("fail-closed-except", "kernel_wrapper_refuses_instead_of_raising", "kernels/attention.py", """
        def attention(self, req, q):
            try:
                return _launch(q)
            except RuntimeError as exc:
                self._fail_closed_error(req, scope="s", trigger="t", reason=str(exc))
        """, violating=True, neutral=False),
    Case("fail-closed-except", "refusal_helper", "serving/handler.py", """
        def step(self, req, risky):
            try:
                risky()
            except Exception as exc:
                self._fail_closed_error(
                    req, scope="decode_step", trigger="t", reason=str(exc)
                )
        """, violating=False),
    Case("fail-closed-except", "fault_carried_to_join", "serving/handler.py", """
        def run(job):
            try:
                job.fn()
            except BaseException as exc:
                job.error = exc
        """, violating=False),
    Case("fail-closed-except", "reraise", "serving/handler.py", """
        def step(risky):
            try:
                risky()
            except KeyError as exc:
                raise RuntimeError("mapped") from exc
        """, violating=False),
    Case("fail-closed-except", "kernel_wrapper_reraises", "kernels/attention.py", """
        def attention(q, k, v):
            try:
                return _launch(q, k, v)
            except OSError as exc:
                raise RuntimeError("flash_attention: library failed to load") from exc
        """, violating=False, neutral=False),
    # ------------------------------------------------------- metric-drift
    Case("metric-drift", "registered_not_reconciled", "helper.py", """
        def setup(registry):
            return registry.counter("bogus_total", "never reconciled")
        """, violating=True),
    Case("metric-drift", "unresolvable_increment", "helper.py", """
        def tick(self):
            self._mystery.increment("trigger")
        """, violating=True),
    Case("metric-drift", "reconciled_but_unregistered", "helper.py", """
        def check(snap):
            return _counter_series(snap, "renamed_away_total")
        """, violating=True),
    Case("metric-drift", "registered_and_reconciled", "helper.py", """
        def setup(registry):
            fam = registry.counter("fail_closed_total", "h", labels=("trigger",))
            fam.increment("boom")
            return fam

        def check(snap):
            return _counter_series(snap, "fail_closed_total")
        """, violating=False),
    Case("metric-drift", "exempt_gauge", "helper.py", """
        def setup(registry):
            return registry.gauge("tier_blocks", "occupancy", labels=("tier",))
        """, violating=False),
    # ---------------------------------------------------- nondeterminism
    Case("nondeterminism", "wall_clock", "helper.py", """
        import time

        def stamp():
            return time.time()
        """, violating=True),
    Case("nondeterminism", "unseeded_stdlib_random", "helper.py", """
        import random

        def draw():
            return random.random()
        """, violating=True),
    Case("nondeterminism", "legacy_numpy_random", "helper.py", """
        import numpy as np

        def draw():
            return np.random.rand(3)
        """, violating=True),
    Case("nondeterminism", "clock_in_emit_payload", "core_engine.py", """
        import time

        def note(log):
            log.emit("stage_latency", stage="x", seconds=time.monotonic())
        """, violating=True),
    Case("nondeterminism", "torch_draw_from_global_generator", "helper.py", """
        import torch

        def draw():
            return torch.randn(3, 4)
        """, violating=True, neutral=False),
    Case("nondeterminism", "torch_randint_from_global_generator", "helper.py", """
        import torch

        def seed():
            return int(torch.randint(0, 2**62, (1,)))
        """, violating=True, neutral=False),
    Case("nondeterminism", "in_place_normal_without_generator", "helper.py", """
        import torch

        def init(w):
            return w.normal_(0.0, 0.02)
        """, violating=True, neutral=False),
    Case("nondeterminism", "sanctioned_clocks_and_rngs", "helper.py", """
        import random
        import time

        import numpy as np

        def ok():
            t = time.monotonic()
            rng = np.random.default_rng(1234)
            r = random.Random(7)
            return t, rng, r
        """, violating=False),
    Case("nondeterminism", "torch_draws_with_generators", "helper.py", """
        import torch

        def init(shape, device):
            g = torch.Generator(device=device).manual_seed(0)
            w = torch.randn(shape, generator=g, device=device)
            idx = torch.randperm(shape[0], generator=g)
            return w.normal_(0.0, 0.02, generator=g), idx
        """, violating=False, neutral=False),
    # ------------------------------------------------- device-path-purity
    Case("device-path-purity", "item_in_a_model", "models/layers.py", """
        def decode_slot(cache_len, cur_pos):
            return min(int(cur_pos.max().item()), cache_len - 1)
        """, violating=True, neutral=False),
    Case("device-path-purity", "device_indices_read_back_in_a_wrapper", "kernels/kv_block_copy.py", """
        import torch

        def kv_block_copy(src, indices):
            idx = torch.as_tensor(indices).cpu()
            return src.index_select(0, idx.to(src.device))
        """, violating=True, neutral=False),
    Case("device-path-purity", "synchronize_in_a_wrapper", "kernels/flash_attention.py", """
        import torch

        def flash_attention(q, k, v):
            out = _launch(q, k, v)
            torch.cuda.synchronize()
            return out
        """, violating=True, neutral=False),
    Case("device-path-purity", "clock_in_a_model", "models/whisper.py", """
        import time

        def encode(params, frames):
            t0 = time.monotonic()
            return frames, time.monotonic() - t0
        """, violating=True, neutral=False),
    Case("device-path-purity", "metric_in_a_wrapper", "kernels/paged_attention.py", """
        def paged_decode_attention(q, metrics):
            metrics.kernel_launches.inc()
            return q
        """, violating=True, neutral=False),
    Case("device-path-purity", "tolist_in_a_model", "models/moe.py", """
        def route(gates):
            return gates.argmax(-1).tolist()
        """, violating=True, neutral=False),
    Case("device-path-purity", "int_of_a_reduction_in_a_wrapper", "kernels/kv_block_copy.py", """
        def check_range(idx, n):
            if int(idx.min()) < 0 or int(idx.max()) >= n:
                raise IndexError(n)
        """, violating=True, neutral=False),
    Case("device-path-purity", "float_of_a_reduction_in_a_model", "models/layers.py", """
        def scale(x):
            return x / float(x.abs().max())
        """, violating=True, neutral=False),
    Case("device-path-purity", "bool_of_a_comparison_in_a_model", "models/moe.py", """
        import torch

        def overflowed(counts, capacity):
            return bool(torch.any(counts > capacity))
        """, violating=True, neutral=False),
    Case("device-path-purity", "to_cpu_in_a_model", "models/whisper.py", """
        import torch

        def frames_on_host(frames):
            return frames.to("cpu"), frames.to(device=torch.device("cpu"))
        """, violating=True, neutral=False),
    Case("device-path-purity", "copy_into_a_host_tensor_in_a_wrapper", "kernels/flash_attention.py", """
        import torch

        def lse_on_host(lse):
            return torch.empty_like(lse, device="cpu").copy_(lse)
        """, violating=True, neutral=False),
    Case("device-path-purity", "host_scalars_in_a_wrapper", "kernels/flash_attention.py", """
        import math

        def launch_args(causal, window, shape, d):
            return (int(bool(causal)), int(window), int(len(shape)),
                    int(math.ceil(d / 8)) * 8, float(1.0 / math.sqrt(d)))
        """, violating=False, neutral=False),
    Case("device-path-purity", "moves_to_the_device_in_a_model", "models/layers.py", """
        def to_device(idx, like):
            return idx.to(like.device), idx.to("cuda", non_blocking=True)
        """, violating=False, neutral=False),
    Case("device-path-purity", "pure_model_code", "models/layers.py", """
        import torch

        def slot_update(cache, value, slot):
            hit = torch.arange(cache.shape[1], device=cache.device)[None, :] == slot[:, None]
            return torch.where(hit[..., None], value.to(cache.dtype), cache)
        """, violating=False, neutral=False),
    Case("device-path-purity", "build_module_times_nvcc", "kernels/build.py", """
        import time

        def build_all(compile_source):
            t0 = time.monotonic()
            compile_source("flash_attention")
            return time.monotonic() - t0
        """, violating=False, neutral=False),
    Case("device-path-purity", "engine_reads_back_at_the_step_boundary", "serving/engine.py", """
        def greedy(logits):
            return logits.argmax(-1).tolist()
        """, violating=False, neutral=False),
]


def _write(tmp_path: Path, case: Case) -> Path:
    path = tmp_path / case.filename
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(case.code))
    return path


def _active(findings: List[Finding]) -> List[Finding]:
    return [f for f in findings if not f.suppressed]


@pytest.mark.parametrize("case", CASES, ids=[f"{c.rule}-{c.name}" for c in CASES])
def test_fixture_catalogue(tmp_path, case):
    path = _write(tmp_path, case)
    findings = _active(lint_paths([str(path)], only=(case.rule,)))
    if case.violating:
        assert findings, f"{case.rule}/{case.name}: expected a finding, got none"
        assert all(f.rule == case.rule for f in findings)
    else:
        assert not findings, (
            f"{case.rule}/{case.name}: expected clean, got "
            + "; ".join(f"{f.location()} {f.message}" for f in findings)
        )


def test_every_rule_has_violating_and_conforming_fixtures():
    rules = {cls.rule_id for cls in ALL_RULES}
    assert rules == set(SHARED_RULES) | {"device-path-purity"}
    assert {c.rule for c in CASES if c.violating} == rules
    assert {c.rule for c in CASES if not c.violating} == rules
    for rule in rules:
        assert sum(1 for c in CASES if c.rule == rule and c.violating) >= 2


NEUTRAL = [c for c in CASES if c.neutral and c.rule in SHARED_RULES]


@pytest.mark.parametrize("case", NEUTRAL, ids=[f"{c.rule}-{c.name}" for c in NEUTRAL])
def test_parity_with_the_jax_linter(tmp_path, case):
    """Both linters give the same (rule, line, suppressed) findings on a
    framework-neutral source, one rule at a time and all rules at once
    (the port's device-path-purity aside, which has no JAX twin)."""
    path = _write(tmp_path, case)
    key = lambda fs: sorted((f.rule, f.line, f.suppressed) for f in fs)
    for only in ((case.rule,), SHARED_RULES):
        assert key(lint_paths([str(path)], only=only)) == key(jax_lint_paths([str(path)], only=only))


def test_parity_with_the_jax_linter_on_suppressions(tmp_path):
    path = tmp_path / "helper.py"
    path.write_text(
        "import time\n"
        "a = time.time()  # lint: allow[nondeterminism] frozen fixture\n"
        "b = time.time()  # lint: allow[nondeterminism]\n"
        "c = time.time()\n"
    )
    key = lambda fs: sorted((f.rule, f.line, f.suppressed, f.message) for f in fs)
    assert key(lint_paths([str(path)])) == key(jax_lint_paths([str(path)], only=SHARED_RULES))


def test_schemas_the_rules_check_against_match_the_reference():
    """emit-site and metric-drift judge the same tree alike in both packages
    only while the schemas and exemptions agree."""
    from repro.analysis import rules_events as j_ev
    from repro.analysis import rules_metrics as j_me
    from repro.core import events as j_events
    from repro_torch.analysis import rules_events as t_ev
    from repro_torch.analysis import rules_metrics as t_me
    from repro_torch.core import events as t_events

    assert t_events.ALL_EVENT_NAMES == j_events.ALL_EVENT_NAMES
    assert t_events.PAYLOAD_SCHEMA == j_events.PAYLOAD_SCHEMA
    assert t_events.PAYLOAD_OPTIONAL == j_events.PAYLOAD_OPTIONAL
    assert t_ev.BOUNDARY_MODULES == j_ev.BOUNDARY_MODULES
    assert set(t_me.EXEMPT) == set(j_me.EXEMPT)


def test_boundary_modules_exist_in_the_port():
    from repro_torch.analysis.rules_events import BOUNDARY_MODULES

    stems = {p.stem for p in SRC.rglob("*.py")}
    assert BOUNDARY_MODULES <= stems, sorted(BOUNDARY_MODULES - stems)


def test_real_tree_lints_clean():
    """The port's tree passes its own gate: zero unsuppressed findings, and
    every suppression documents why."""
    findings = lint_paths([str(SRC)])
    active = _active(findings)
    assert not active, "; ".join(f"{f.location()} {f.rule} {f.message}" for f in active)
    suppressed = [f for f in findings if f.suppressed]
    assert suppressed, "expected the tree's deliberate sites to be suppressed"
    assert all(f.suppress_reason for f in suppressed)
    # the device path's only suppressions are two scalar reads of HOST
    # tensors: kv_block_copy's range check of its host indices, and
    # init_params' one seed draw
    device = sorted({(Path(f.path).name, f.line) for f in suppressed
                     if f.rule == "device-path-purity"})
    assert [name for name, _ in device] == ["kv_block_copy.py", "transformer.py"], device


def test_real_tree_device_path_is_in_scope():
    """The purity rule really reads the port's models and kernel wrappers:
    every one of them is in its scope, and build.py is not."""
    from repro_torch.analysis.framework import load_files
    from repro_torch.analysis.rules_purity import in_device_path

    files = {f.path.name: f for f in load_files([str(SRC / "models"), str(SRC / "kernels")])}
    assert not in_device_path(files["build.py"])
    for name in ("layers.py", "transformer.py", "whisper.py", "flash_attention.py",
                 "kv_block_copy.py", "paged_attention.py"):
        assert in_device_path(files[name]), name


def test_tamper_with_finally_block_is_caught(tmp_path):
    good = next(c for c in CASES if c.name == "pin_with_finally_unwind")
    tampered = textwrap.dedent(good.code).replace("unpin_chain(blocks)", "pass")
    assert "unpin_chain" not in tampered
    path = tmp_path / "helper.py"
    path.write_text(tampered)
    findings = _active(lint_paths([str(path)], only=("pin-balance",)))
    assert findings and "no unpin_chain" in findings[0].message


def test_tamper_with_kernel_reraise_is_caught(tmp_path):
    """Dropping the re-raise from a conforming kernel handler flips it."""
    good = next(c for c in CASES if c.name == "kernel_wrapper_reraises")
    tampered = textwrap.dedent(good.code).replace(
        'raise RuntimeError("flash_attention: library failed to load") from exc', "return None"
    )
    assert "raise" not in tampered
    path = tmp_path / "kernels" / "attention.py"
    path.parent.mkdir()
    path.write_text(tampered)
    findings = _active(lint_paths([str(path)], only=("fail-closed-except",)))
    assert findings and "does not re-raise" in findings[0].message


def test_suppression_with_reason_suppresses(tmp_path):
    path = tmp_path / "helper.py"
    path.write_text(
        "import time\n"
        "t = time.time()  # lint: allow[nondeterminism] frozen test fixture\n"
    )
    findings = lint_paths([str(path)], only=("nondeterminism",))
    assert findings and all(f.suppressed for f in findings)
    assert findings[0].suppress_reason == "frozen test fixture"


def test_suppression_on_the_line_above(tmp_path):
    path = tmp_path / "models" / "layers.py"
    path.parent.mkdir()
    path.write_text(
        "def f(x):\n"
        "    # lint: allow[device-path-purity] host-side shape probe\n"
        "    return x.tolist()\n"
    )
    findings = lint_paths([str(path)], only=("device-path-purity",))
    assert findings and all(f.suppressed for f in findings)


def test_reasonless_suppression_does_not_suppress(tmp_path):
    path = tmp_path / "helper.py"
    path.write_text("import time\nt = time.time()  # lint: allow[nondeterminism]\n")
    messages = [f.message for f in _active(lint_paths([str(path)], only=("nondeterminism",)))]
    assert any("wall-clock" in m for m in messages)
    assert any("carries no reason" in m for m in messages)


def test_strict_cli_exit_codes_and_report(tmp_path):
    bad = tmp_path / "helper.py"
    bad.write_text("import torch\nx = torch.rand(3)\n")
    report = tmp_path / "report.json"
    assert lint_main([str(bad), "--strict", "--json", str(report)]) == 1
    data = json.loads(report.read_text())
    assert data["tool"] == "repro_torch.analysis.lint"
    assert data["counts"]["findings"] >= 1
    assert data["counts"]["by_rule"]["nondeterminism"] >= 1
    assert set(data["counts"]["by_rule"]) == {cls.rule_id for cls in ALL_RULES}
    assert all({"rule", "file", "line", "message", "hint"} <= set(f) for f in data["findings"])

    good = tmp_path / "clean.py"
    good.write_text("X = 1\n")
    assert lint_main([str(good), "--strict", "--json", ""]) == 0


def test_rule_filter_cli(tmp_path):
    bad = tmp_path / "helper.py"
    bad.write_text("import time\nt = time.time()\n")
    assert lint_main([str(bad), "--strict", "--rules", "pin-balance", "--json", ""]) == 0


def test_module_cli_writes_the_port_report_only(tmp_path):
    """``python -m repro_torch.analysis.lint src/repro_torch --strict`` exits
    0 and writes results/torch/lint_report.json (relative to its working
    directory), never the JAX linter's results/lint_report.json."""
    assert DEFAULT_REPORT == "results/torch/lint_report.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", str(SRC), "--strict"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads((tmp_path / DEFAULT_REPORT).read_text())
    assert report["counts"]["findings"] == 0
    assert not (tmp_path / "results" / "lint_report.json").exists()


# --------------------------------------------------------------- runtime twin


def test_payload_schema_covers_every_event():
    assert frozenset(PAYLOAD_SCHEMA) == ALL_EVENT_NAMES


def test_runtime_payload_validation_rejects_what_the_linter_rejects():
    log = EventLog()
    with pytest.raises(ValueError, match="missing required keys"):
        log.emit("stage_latency", stage="prefill")
    with pytest.raises(ValueError, match="undeclared keys"):
        log.emit("stage_latency", stage="prefill", seconds=0.1, color="red")
    with pytest.raises(ValueError, match="unknown event name"):
        log.emit("totally_unknown_event")
    ev = log.emit("stage_latency", stage="prefill", seconds=0.1)
    assert ev.payload == {"stage": "prefill", "seconds": 0.1}
