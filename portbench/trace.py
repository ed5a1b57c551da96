"""What a traced run (``--trace 1``) reads: the shapes of each launch of the
port's three kernels, the device's activity from ``torch.profiler``, and
the program's ``obs`` spans, all on the host's clock.

Launches are recorded around the port's Python entry points of the
kernels (``tcec_matmul.enqueue``, ``tcec_attention._launch``,
``tcec_paged_attention._enqueue``), in the traced run only.  A launch made
while a CUDA graph is captured is recorded once as part of that graph;
each replay of the graph repeats it.

Device intervals are the profiler's kernel, copy and set records, put
onto the host's clock by a marker kernel (:class:`Profiler`).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

# the port's kernels by the names of their CUDA kernels
KERNEL_NAMES = {"k1_path_s": ("skinny_kernel",),
                "k1_path_w": ("wide_kernel",),
                "k2": ("tcec_attention_kernel",),
                "k3": ("paged_chunk_kernel", "paged_combine_kernel")}


@dataclass
class Launch:
    kernel: str                 # k1, k2, k3
    shape: dict
    in_graph: bool


class Recorder:
    """Wraps the kernels' entry points; ``on`` gates the eager records."""

    def __init__(self):
        self.on = False
        self.eager: list[Launch] = []
        self.graph: list[Launch] = []
        self._undo = []

    def _keep(self, kernel, shape):
        import torch
        if torch.cuda.is_current_stream_capturing():
            self.graph.append(Launch(kernel, shape, True))
        elif self.on:
            self.eager.append(Launch(kernel, shape, False))

    def install(self) -> bool:
        """Wrap the entry points; False where the port has none of them."""
        try:
            from repro_torch.kernels import (tcec_attention,
                                             tcec_matmul,
                                             tcec_paged_attention)
        except ImportError:
            return False
        rec = self
        paths: dict = {}

        def rule(M):
            if M not in paths:
                paths[M] = 0 if tcec_matmul.path(M) == "skinny" else 1
            return paths[M]

        def k1(orig):
            def enqueue(a, b, policy="tcec_bf16x6", bias=None,
                        activation=None, out_scale=1.0, path=None, out=None):
                *bd, M, K = a.shape
                N = b.shape[-1]
                p = path if path is not None else rule(M)
                rec._keep("k1", {"batch": bd[0] if bd else 1, "M": M,
                                 "N": N, "K": K, "bias": bias is not None,
                                 "path": "s" if p == 0 else "w"})
                return orig(a, b, policy, bias, activation, out_scale, path,
                            out)
            return enqueue

        def k2(orig):
            def launch(q, k, v, qp, kp, pol, causal, window, softcap,
                       sm_denom):
                B, S, H, hd = q.shape
                rec._keep("k2", {"B": B, "S": S, "T": k.shape[1], "H": H,
                                 "Hkv": k.shape[2], "hd": hd,
                                 "hdv": v.shape[3], "causal": bool(causal),
                                 "window": int(window)})
                return orig(q, k, v, qp, kp, pol, causal, window, softcap,
                            sm_denom)
            return launch

        def k3(orig):
            def enqueue(qt, k_pages, v_pages, block_tables, lengths, pol,
                        window, softcap, sm_denom, C):
                B, Hkv, rep, hd = qt.shape
                rec._keep("k3", {"B": B, "Hkv": Hkv, "rep": rep, "hd": hd,
                                 "hdv": v_pages.shape[3],
                                 "ps": k_pages.shape[1],
                                 "elem": k_pages.element_size()})
                return orig(qt, k_pages, v_pages, block_tables, lengths, pol,
                            window, softcap, sm_denom, C)
            return enqueue

        for mod, name, wrap in ((tcec_matmul, "enqueue", k1),
                                (tcec_attention, "_launch", k2),
                                (tcec_paged_attention, "_enqueue", k3)):
            orig = getattr(mod, name, None)
            if orig is None:
                continue
            setattr(mod, name, wrap(orig))
            self._undo.append((mod, name, orig))
        return bool(self._undo)

    def uninstall(self):
        for mod, name, orig in self._undo:
            setattr(mod, name, orig)
        self._undo.clear()


@dataclass
class DeviceTrace:
    events: list = field(default_factory=list)   # (name, start_s, end_s)
    ok: bool = False


class Profiler:
    """The profiler over the window, CUDA activity only (the kernels, copies
    and sets, and the CUDA runtime's calls; no record of every host
    operation, which would slow the host-bound steps it measures).  Its
    records are read raw: the profiler's own Python post-processing of a
    window's million records takes minutes.  The device's clock is put onto
    the host's by one marker kernel launched just after a synchronize at a
    known host time: the window's first device record."""

    def __init__(self):
        self.prof = None
        self.t_mark = None

    def start(self):
        import torch
        torch.cuda.synchronize()
        self.prof = torch.autograd.profiler.profile(
            use_device="cuda", use_cpu=False, use_kineto=True)
        self.prof._prepare_trace()
        self.prof._start_trace()
        mark = torch.empty(1, device="cuda")
        torch.cuda.synchronize()
        self.t_mark = time.perf_counter()
        mark.fill_(1.0)
        torch.cuda.synchronize()

    def stop(self) -> DeviceTrace:
        import torch
        from torch.autograd import profiler as P
        torch.cuda.synchronize()
        results = torch._C._autograd._disable_profiler()
        if hasattr(P, "_run_on_profiler_stop"):
            P._run_on_profiler_stop()
        return self._read(results)

    def _read(self, results) -> DeviceTrace:
        from torch.autograd import DeviceType
        out = DeviceTrace()
        cuda = DeviceType.CUDA
        dev = []
        for e in results.events():
            if e.device_type() == cuda:
                d = e.duration_ns()
                if d > 0:
                    dev.append((e.name(), e.start_ns(), d))
        if not dev:
            return out
        first = min(s for _, s, _ in dev)
        offset = first * 1e-9 - self.t_mark
        out.events = [(n, s * 1e-9 - offset, (s + d) * 1e-9 - offset)
                      for n, s, d in dev]
        out.ok = True
        return out


class Busy:
    """The union of intervals, merged once, for many busy-time queries."""

    def __init__(self, intervals):
        import bisect
        self._bisect = bisect
        merged = []
        for s, e in sorted(intervals):
            if merged and s <= merged[-1][1]:
                if e > merged[-1][1]:
                    merged[-1][1] = e
            else:
                merged.append([s, e])
        self.starts = [s for s, _ in merged]
        self.ends = [e for _, e in merged]
        self.cum = [0.0]
        for s, e in merged:
            self.cum.append(self.cum[-1] + e - s)

    def _upto(self, t: float) -> float:
        """Busy seconds before ``t``."""
        i = self._bisect.bisect_right(self.starts, t)
        if i == 0:
            return 0.0
        return self.cum[i - 1] + min(self.ends[i - 1], t) - self.starts[i - 1]

    def seconds(self, lo: float, hi: float) -> float:
        return max(0.0, self._upto(hi) - self._upto(lo))


def idle_gaps(intervals, lo: float, hi: float):
    """The gaps ``(start, end)`` in ``[lo, hi]`` where no interval runs."""
    gaps, t = [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def spans_of(tracer) -> list:
    """The ``obs`` tracer's complete spans as ``(name, start, end, args)``
    on the host's clock (``time.perf_counter`` seconds)."""
    if tracer is None:
        return []
    t0 = tracer._t0
    out = []
    for ev in tracer.chrome()["traceEvents"]:
        if ev.get("ph") == "X":
            s = t0 + ev["ts"] * 1e-6
            out.append((ev["name"], s, s + ev["dur"] * 1e-6,
                        ev.get("args", {})))
    return out


def request_events(tracer) -> list:
    """``(name, rid, time)`` of the tracer's request events."""
    if tracer is None:
        return []
    t0 = tracer._t0
    return [(ev["name"] if ev["ph"] != "b" else "enqueue", ev["id"],
             t0 + ev["ts"] * 1e-6)
            for ev in tracer.chrome()["traceEvents"]
            if ev.get("ph") in ("b", "n", "e")]
