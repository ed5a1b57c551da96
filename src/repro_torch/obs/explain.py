"""Dispatch explainability: why did a call (not) take its kernel?

Every rule walk in ``kernels/dispatch.py`` — kernel 1 (``matmul``), kernel
2 (``attention``), kernel 3 (``paged_attention``) and the epilogue hook
(``epilogue``) — records which rule accepted or declined it, keyed like the
circuit breaker: ``(device type, kernel, policy, *shape bucket)``.  The
device type of the operand takes the place of JAX's
``jax.default_backend()``; the epilogue hook has no operand and records
the device its caller names.

**The port records per call, JAX per trace.**  JAX's dispatch runs while
``jit`` traces, so a cached executable records nothing more.  The port runs
eagerly: every call records, 7L + 1 kernel-1 and L kernel-2 decisions a
dense prefill (L layers), and two epilogue decisions a layer under
``fuse_epilogue``.  A CUDA graph replay runs no
Python, so the engine's decode graph records only while it is captured;
the replayed steps add nothing.  :func:`record` is one lock, one dict
update and two counter increments.

``use_plain()`` and ``interpret=True`` record ``fused``: the call took the
kernel's route, and the route ran the kernel's plain version.

Counts also land in the metrics registry (``kernels/dispatch/route`` and
``kernels/dispatch/decline`` counters), so snapshots carry the totals even
after :func:`reset`.  JAX slugs the port never emits: ``off-backend`` (a
CUDA operand launches, a CPU operand runs the plain version; there is no
backend rule) and ``vmem-budget`` (no VMEM).
"""
from __future__ import annotations

import threading

from . import metrics

#: rule slug -> what it means in the port.  "fused" is the acceptance;
#: every other slug names the rule that declined.
RULES = {
    "fused": "routed to the kernel's public wrapper: the CUDA kernel for a "
             "CUDA operand, its plain version for a CPU operand, under "
             "use_plain() or under interpret",
    "plain-policy": "plain policy (fp32/bf16): one f32 product, nothing to "
                    "correct or fuse",
    "policy-ineligible": "not a policy the kernels take (bf16 split "
                         "policies on the triangular schedule, x3 / x6 / "
                         "x10): upcast fp16 / fp8 policies take the term "
                         "expansion, x9 its TwoSum loop",
    "hatch-disabled": "an escape hatch is off: enabled / flash_attention / "
                      "paged_attention / fuse_epilogue (REPRO_DISABLE_PALLAS "
                      "and the granular variables)",
    "shape-unsupported": "the operands are not the model layout the "
                         "attention kernels take",
    "below-min-dim": "a problem dim is under min_dim (0 by default)",
    "mesh-declined": "a mesh is installed but the shard_map knob is off, "
                     "the context runs DP over the model axis, or "
                     "kernels/shmap.py has no per-shard plan for these "
                     "shapes (rule 6)",
    "breaker-open": "the circuit breaker has this key quarantined after "
                    "repeated kernel failures: KernelQuarantined was raised "
                    "and nothing launched (kernels/guard.py)",
    "kernel-failure": "the kernel raised; the error propagated (counted by "
                      "kernels/guard.py)",
}

_LOCK = threading.Lock()
_DECISIONS: dict[tuple, dict] = {}

#: bound on distinct decision keys (shape sweeps); overflow is counted,
#: never silent.
MAX_KEYS = 4096

_ROUTES = metrics.counter("kernels/dispatch/route")
_DECLINES = metrics.counter("kernels/dispatch/decline")
_OVERFLOW = metrics.counter("kernels/dispatch/explain_overflow")
# (kernel, rule) -> the counter series one decision increments, resolved
# once: the port records on every call, not once a trace
_SERIES: dict[tuple, tuple] = {}


def _series(kernel: str, rule: str) -> tuple:
    incs = _SERIES.get((kernel, rule))
    if incs is None:
        fused = rule == "fused"
        incs = (_ROUTES.series(kernel=kernel,
                               route="fused" if fused else "fallback"),)
        if not fused:
            incs += (_DECLINES.series(kernel=kernel, rule=rule),)
        _SERIES[(kernel, rule)] = incs
    return incs


def record(device: str, kernel: str, policy: str, bucket: tuple, rule: str):
    """Record one routing decision.  ``device`` is the operand's device
    type (``"cuda"``, ``"cpu"``); ``bucket`` is the shape-bucket part of
    the key (the guard ident without the policy)."""
    if rule not in RULES:
        raise ValueError(f"unknown dispatch rule {rule!r}; "
                         f"known: {sorted(RULES)}")
    key = (device, kernel, str(policy)) + tuple(bucket)   # str at report
    with _LOCK:
        rules = _DECISIONS.get(key)
        if rules is None and len(_DECISIONS) < MAX_KEYS:
            rules = _DECISIONS[key] = {}
        if rules is not None:
            # per-rule counts: a key may flip route over its lifetime
            # (breaker opens, config scopes); keep every decision
            rules[rule] = rules.get(rule, 0) + 1
    if rules is None:
        _OVERFLOW.inc()
    for inc in _series(kernel, rule):
        inc()


class Report:
    """Materialized view of every recorded decision."""

    def __init__(self, entries: list[dict]):
        self.entries = entries

    @property
    def n_fused(self) -> int:
        return sum(e["count"] for e in self.entries
                   if e["rule"] == "fused")

    @property
    def n_fallback(self) -> int:
        """Declined decisions (JAX's name: a decline takes the plain
        PyTorch path the caller keeps, never the kernel's plain version)."""
        return sum(e["count"] for e in self.entries
                   if e["rule"] != "fused")

    def fallbacks(self) -> list[dict]:
        return [e for e in self.entries if e["rule"] != "fused"]

    def lines(self) -> list[str]:
        out = []
        for e in sorted(self.entries,
                        key=lambda e: (-e["count"], e["key"])):
            label = ("fused" if e["rule"] == "fused"
                     else f"fallback({e['rule']})")
            out.append(f"{e['key']}: {label} x{e['count']}")
        return out

    def __str__(self):
        if not self.entries:
            return "dispatch explain: no decisions recorded"
        head = (f"dispatch explain: {self.n_fused} fused / "
                f"{self.n_fallback} fallback decisions")
        return "\n".join([head] + ["  " + ln for ln in self.lines()])


def report(reset: bool = False) -> Report:
    """Everything recorded so far (optionally clearing the table)."""
    with _LOCK:
        entries = [{"key": "/".join(map(str, key)), "backend": key[0],
                    "kernel": key[1], "policy": key[2],
                    "bucket": tuple(map(str, key[3:])), "rule": rule,
                    "count": count}
                   for key, rules in _DECISIONS.items()
                   for rule, count in rules.items()]
        if reset:
            _DECISIONS.clear()
    return Report(entries)


def decisions() -> dict[str, dict]:
    """Raw ``{key: {rule: count}}`` view (keys "/"-joined)."""
    with _LOCK:
        return {"/".join(map(str, k)): dict(v)
                for k, v in _DECISIONS.items()}


def reset():
    with _LOCK:
        _DECISIONS.clear()
