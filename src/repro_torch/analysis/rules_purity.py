"""L5 — nondeterminism, and L6 — device-path purity.

L5 enforces the two-clock contract statically: the analyzer orders by
``seq`` and never by wall-clock, ``Event.ts`` is stamped from
``time.monotonic()`` at exactly one site, and chaos draws are seeded
sha256 streams.  Anything else that could make two runs of the same
seeded campaign diverge — ``time.time()``, ``datetime.now()``, unseeded
``random``/``np.random``, a torch random draw from the global generator —
is a finding.  ``time.monotonic()`` is legal everywhere (durations);
``np.random.default_rng(seed)`` / ``random.Random(seed)`` with an explicit
seed are the sanctioned generator constructions, and a torch draw
(``torch.rand*``, ``torch.randint``, ``torch.randperm``, ``torch.normal``,
the in-place ``Tensor.normal_`` family) is legal when it names its
``generator=`` — the torch counterpart of a threaded ``jax.random`` key.

L6 replaces the JAX package's ``jit-purity``.  The port runs no tracing
compiler, but ``models/`` and the kernel wrappers in ``kernels/`` run once
per layer per step, between launches the card queues ahead of the host.
There, an event emission or metric touch mixes host bookkeeping into the
step (the engine owns both, at the step's boundary), a clock read times
the host's queueing and not the card's work, and a device-to-host sync
(``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, a
``synchronize``, ``int``/``float``/``bool`` of a call's result such as
``int(t.max())``, ``.to("cpu")``, a ``.copy_`` into a tensor made on
the CPU) stalls the card until the host catches up.
``kernels/build.py``, which compiles the sources with nvcc and times the
builds, is outside the device path.
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Optional

from repro_torch.analysis.framework import FileContext, Finding, Rule, dotted_name

_WALL_CLOCK = frozenset({"time.time", "datetime.now", "datetime.utcnow", "datetime.today",
                         "datetime.datetime.now", "datetime.datetime.utcnow"})
_NP_RANDOM_LEGACY = frozenset(
    {
        "rand", "randn", "randint", "random", "random_sample", "choice",
        "shuffle", "permutation", "seed", "uniform", "normal", "standard_normal",
    }
)
_PY_RANDOM_UNSEEDED = frozenset(
    {
        "random", "randint", "randrange", "choice", "choices", "shuffle",
        "sample", "uniform", "gauss", "seed", "getrandbits",
    }
)
# torch draws that read the global generator unless given generator=
_TORCH_RANDOM = frozenset(
    {
        "rand", "randn", "randint", "randperm", "normal", "bernoulli",
        "multinomial", "poisson", "rand_like", "randn_like", "randint_like",
    }
)
_TENSOR_RANDOM_INPLACE = frozenset(
    {
        "normal_", "uniform_", "random_", "bernoulli_", "exponential_",
        "geometric_", "cauchy_", "log_normal_",
    }
)

# device-path purity: host side effects banned in models/ and kernels/
_EVENT_ATTRS = frozenset({"emit"})
_METRIC_ATTRS = frozenset({"inc", "increment", "observe"})
_SYNC_ATTRS = frozenset({"item", "tolist", "cpu", "numpy", "synchronize"})
_SYNC_NAMES = frozenset({"device_sync"})
_SCALAR_CASTS = frozenset({"int", "float", "bool"})  # of a call's result
_MOVE_ATTRS = frozenset({"to", "copy_"})  # with a "cpu" argument
_OFF_DEVICE_PATH = frozenset({"build"})  # kernels/build.py compiles with nvcc


def _has_generator(node: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in node.keywords)


class NondeterminismRule(Rule):
    rule_id = "nondeterminism"
    doc = (
        "no wall-clock (time.time/datetime.now) or unseeded randomness; "
        "time.monotonic + seeded generators + torch draws with generator= only"
    )

    def _check_call(self, ctx: FileContext, node: ast.Call) -> Iterable[Finding]:
        name = dotted_name(node.func)
        if name in _WALL_CLOCK:
            yield Finding(
                rule=self.rule_id,
                path=ctx.rel,
                line=node.lineno,
                message=f"wall-clock call {name}()",
                hint="use time.monotonic() for durations; Event.ts (stamped in "
                "EventLog.emit) is the only sanctioned clock field",
            )
        elif name.startswith("np.random.") or name.startswith("numpy.random."):
            leaf = name.rsplit(".", 1)[1]
            if leaf in _NP_RANDOM_LEGACY:
                yield Finding(
                    rule=self.rule_id,
                    path=ctx.rel,
                    line=node.lineno,
                    message=f"unseeded legacy numpy random {name}()",
                    hint="construct np.random.default_rng(seed) and thread it",
                )
            elif leaf == "default_rng" and not node.args:
                yield Finding(
                    rule=self.rule_id,
                    path=ctx.rel,
                    line=node.lineno,
                    message="np.random.default_rng() without a seed",
                    hint="pass an explicit seed so campaigns replay",
                )
        elif name.startswith("torch.") and name.split(".", 1)[1] in _TORCH_RANDOM:
            if not _has_generator(node):
                yield Finding(
                    rule=self.rule_id,
                    path=ctx.rel,
                    line=node.lineno,
                    message=f"{name}() draws from torch's global generator",
                    hint="pass generator= (a torch.Generator seeded by the "
                    "caller) so the draw replays",
                )
        elif name in ("torch.seed", "torch.random.seed"):
            yield Finding(
                rule=self.rule_id,
                path=ctx.rel,
                line=node.lineno,
                message=f"{name}() seeds torch from a nondeterministic source",
                hint="seed a torch.Generator explicitly with manual_seed(seed)",
            )
        elif (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _TENSOR_RANDOM_INPLACE
            and not _has_generator(node)
        ):
            yield Finding(
                rule=self.rule_id,
                path=ctx.rel,
                line=node.lineno,
                message=f"in-place draw .{node.func.attr}() from torch's global generator",
                hint="pass generator= so the draw replays",
            )
        elif name.startswith("random."):
            leaf = name.split(".", 1)[1]
            if leaf in _PY_RANDOM_UNSEEDED:
                yield Finding(
                    rule=self.rule_id,
                    path=ctx.rel,
                    line=node.lineno,
                    message=f"unseeded stdlib random.{leaf}()",
                    hint="construct random.Random(seed), or derive draws "
                    "statelessly like chaos.py's per-(seed,site) sha256",
                )
        elif name == "random.Random" and not node.args:
            yield Finding(
                rule=self.rule_id,
                path=ctx.rel,
                line=node.lineno,
                message="random.Random() without a seed",
                hint="pass an explicit seed so campaigns replay",
            )

    def run(self, files: List[FileContext]) -> Iterable[Finding]:
        for ctx in files:
            uses_py_random = any(
                isinstance(n, ast.Import) and any(a.name == "random" for a in n.names)
                for n in ast.walk(ctx.tree)
            )
            for node in ast.walk(ctx.tree):
                if not isinstance(node, ast.Call):
                    continue
                name = dotted_name(node.func)
                if name.startswith("random.") and not uses_py_random:
                    continue  # a local name that is not the stdlib module
                yield from self._check_call(ctx, node)
                # wall-clock smuggled into an event payload keyword
                if isinstance(node.func, ast.Attribute) and node.func.attr == "emit":
                    for kw in node.keywords:
                        if kw.arg in (None, "ts"):
                            continue
                        for sub in ast.walk(kw.value):
                            if (
                                isinstance(sub, ast.Call)
                                and dotted_name(sub.func).startswith("time.")
                            ):
                                yield Finding(
                                    rule=self.rule_id,
                                    path=ctx.rel,
                                    line=node.lineno,
                                    message=f"clock call in payload key "
                                    f"{kw.arg!r} of emit",
                                    hint="payloads must stay clock-free — "
                                    "Event.ts is the tracing channel",
                                )


def _device_path_effect(node: ast.Call) -> Optional[str]:
    """What host side effect a call is, or None."""
    f = node.func
    name = dotted_name(f)
    attr = f.attr if isinstance(f, ast.Attribute) else ""
    if attr in _EVENT_ATTRS:
        return "event emission"
    if attr in _METRIC_ATTRS:
        return "metric update"
    if name.startswith("time.") or name.startswith("datetime."):
        return "clock read"
    if attr in _SYNC_ATTRS or (isinstance(f, ast.Name) and f.id in _SYNC_NAMES):
        return "device-to-host sync"
    if (isinstance(f, ast.Name) and f.id in _SCALAR_CASTS and len(node.args) == 1
            and isinstance(node.args[0], ast.Call) and not _host_builtin(node.args[0])):
        return "device-to-host sync"  # int(t.max()): a scalar read of a tensor
    if attr in _MOVE_ATTRS and _call_names_cpu(node):
        return "device-to-host sync"  # t.to("cpu")
    if attr == "copy_" and isinstance(f.value, ast.Call) and _call_names_cpu(f.value):
        return "device-to-host sync"  # torch.empty_like(t, device="cpu").copy_(t)
    return None


def _call_names_cpu(node: ast.Call) -> bool:
    return any(_names_cpu(a) for a in (*node.args, *(k.value for k in node.keywords)))


def _host_builtin(node: ast.Call) -> bool:
    """``int(bool(flag))``, ``int(len(xs))``, ``int(math.ceil(x))``: the
    inner call already gives a host value."""
    if isinstance(node.func, ast.Name):
        return node.func.id in _SCALAR_CASTS | {"len"}
    return dotted_name(node.func).startswith("math.")


def _names_cpu(node: ast.expr) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Call) and dotted_name(node.func) in ("torch.device", "device"):
        return any(_names_cpu(a) for a in node.args)
    return isinstance(node, ast.Constant) and isinstance(node.value, str) \
        and node.value.split(":")[0] == "cpu"


def in_device_path(ctx: FileContext) -> bool:
    rel = ctx.package_rel.replace("\\", "/")
    if "models/" in rel:
        return True
    return "kernels/" in rel and ctx.module_stem not in _OFF_DEVICE_PATH


class DevicePathPurityRule(Rule):
    rule_id = "device-path-purity"
    doc = (
        "no event emission, metric update, clock read or device-to-host sync "
        "(.item/.tolist/.cpu/.numpy/synchronize, int/float/bool of a call, "
        ".to('cpu')) in models/ or the kernel "
        "wrappers in kernels/"
    )

    def run(self, files: List[FileContext]) -> Iterable[Finding]:
        for ctx in files:
            if not in_device_path(ctx):
                continue
            for node in ast.walk(ctx.tree):
                if not isinstance(node, ast.Call):
                    continue
                effect = _device_path_effect(node)
                if effect is None:
                    continue
                yield Finding(
                    rule=self.rule_id,
                    path=ctx.rel,
                    line=node.lineno,
                    message=f"{effect} on the device path: {ast.unparse(node)[:60]}",
                    hint="keep host work at the engine's step boundary; take "
                    "host-side inputs as host tensors instead of reading "
                    "device ones back",
                )
