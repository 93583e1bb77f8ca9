"""Host spans and the profiled sub-window of a traced run.

The benchmark records its own host spans around its calls into the
program (select batch, forward or step enqueue, wait for the batch or the
step) with the host clock, in every run. A traced run then profiles a
short sub-window of a few batches or steps with ``torch.profiler``,
where each span is also a ``record_function`` range, and reduces it:

  * every device operation's interval, its kernel name and its category
    (a frozen copy of the measured package's ``CATEGORIES``);
  * the card's busy time, the union of those intervals, over the
    sub-window's wall time;
  * the idle gaps between them, each labelled with the benchmark span
    that overlapped it most: what the host was doing while the card
    waited.

The profiler sometimes drops kernel records. A sub-window whose kernel
records do not split evenly over its batches, category by category, or
that holds fewer kernels than the runtime launched, is profiled again
(:func:`profile`), and none is reduced from such a window.
"""

from __future__ import annotations

import contextlib
import re
import sys
import time
from dataclasses import dataclass, field

import torch

# (category, pattern of the demangled kernel name); the first match wins.
# Frozen from the measured package's profiling tools: K1-K5 are its
# hand-written kernels, the rest PyTorch's and cuDNN's.
CATEGORIES = (
    ("K1", r"correlate_kernel<[^>]*, false>|cost_volume_mma_kernel"),
    ("K3", r"correlate_kernel<[^>]*, true>|warp_cv_mma_kernel"),
    ("K4a", r"cv_bwd_kernel<[^>]*, false>|cv_bwd_mma_kernel<false"),
    ("K4b", r"cv_bwd_kernel<[^>]*, true>|cv_bwd_mma_kernel<true"),
    ("K2", r"qpw::(stem_(mma_)?kernel|prep_w33|conv_gemm_\w+<[01][,>])"),
    ("K5", r"qpw::(upconv_(mma_)?kernel|prep_wt|conv_gemm_\w+<2[,>])"),
    ("optimizer", r"multi_tensor|[Aa]dam"),
    ("cuDNN", r"cudnn|conv|xmma|implicit|gemm|cutlass|nchwToNhwc|nhwcToNchw"),
    ("gather/scatter", r"index|gather|scatter"),
    ("concat", r"CatArray"),
    ("reduce", r"reduce"),
    ("elementwise", r"elementwise"),
)
KERNEL_CATEGORIES = ("K1", "K2", "K3", "K4a", "K4b", "K5")
SPAN_PREFIX = "perfbench."
SUBWINDOW = SPAN_PREFIX + "subwindow"
_LAUNCH = re.compile(r"^cu(da)?LaunchKernel|^cudaLaunchCooperativeKernel")


def category(name: str) -> str:
    for cat, pattern in CATEGORIES:
        if re.search(pattern, name):
            return cat
    return "other"


def union(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The parts of [lo, hi] that no interval covers."""
    out, at = [], lo
    for a, b in sorted(intervals):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


class Spans:
    """Host-clock spans by name (perf_counter seconds). Under a profiler
    (``profiled``) each span is also a ``record_function`` range, so that
    the trace can label the card's idle gaps with it."""

    def __init__(self, profiled: bool = False):
        self.profiled = profiled
        self.by_name: dict[str, list[float]] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        rf = (torch.profiler.record_function(SPAN_PREFIX + name)
              if self.profiled else contextlib.nullcontext())
        t0 = time.perf_counter()
        with rf:
            yield
        self.by_name.setdefault(name, []).append(time.perf_counter() - t0)


@dataclass
class SubWindow:
    """A reduced sub-window: ``units`` batches or steps, its wall and
    busy seconds, each device operation as (name, category, seconds), the
    idle gaps as (label, seconds), longest first."""
    units: int
    window_s: float
    busy_s: float
    ops: list = field(default_factory=list)
    idle: list = field(default_factory=list)
    n_kernels: int = 0

    def by_category(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for _, cat, s in self.ops:
            out[cat] = out.get(cat, 0.0) + s
        return out

    def breakdown(self, n: int = 10) -> dict:
        """The device operations that took most time (summed by category
        and kernel name) and the longest idle gaps by host span, seconds
        over the sub-window."""
        tot: dict[str, float] = {}
        for name, cat, s in self.ops:
            short = re.sub(r"^void ", "", name).split("<")[0].split("(")[0]
            key = f"{cat}: {short}"[:120]
            tot[key] = tot.get(key, 0.0) + s
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in self.idle[:n]]}


def reduce_events(events, units: int) -> SubWindow | None:
    """A SubWindow from raw profiler events (``kineto_results.events()``),
    or None where records were dropped."""
    cuda = torch.autograd.DeviceType.CUDA
    # the device timeline also holds copies of the host's record_function
    # ranges, under the host range's name: no device operation
    host = {e.name() for e in events if e.device_type() != cuda}
    window = None
    spans, launches, dev = [], 0, []
    for e in events:
        name = e.name()
        t0 = e.start_ns() / 1e9
        t1 = t0 + e.duration_ns() / 1e9
        if e.device_type() == cuda:
            if name not in host:
                dev.append((name, t0, t1))
        elif name == SUBWINDOW:
            window = (t0, t1)
        elif name.startswith(SPAN_PREFIX):
            spans.append((name[len(SPAN_PREFIX):], t0, t1))
        elif _LAUNCH.match(name):
            launches += 1
    if window is None or not dev:
        return None
    lo, hi = window
    dev = [(n, max(a, lo), min(b, hi)) for n, a, b in dev if b > lo and a < hi]
    ops = [(n, category(n), b - a) for n, a, b in dev]
    kernels = [o for o in ops
               if not o[0].startswith(("Memcpy", "Memset"))]
    counts: dict[str, int] = {}
    for _, cat, _ in kernels:
        counts[cat] = counts.get(cat, 0) + 1
    if len(kernels) < launches or any(c % units for c in counts.values()):
        print(f"perfbench: dropped records? {len(kernels)} kernels, "
              f"{launches} launches, {counts} over {units} units",
              file=sys.stderr)
        return None
    intervals = [(a, b) for _, a, b in dev]
    idle = []
    for a, b in gaps(intervals, lo, hi):
        best, label = 0.0, "no span"
        for name, s0, s1 in spans:
            ov = min(b, s1) - max(a, s0)
            if ov > best:
                best, label = ov, name
        idle.append((label, b - a))
    idle.sort(key=lambda kv: -kv[1])
    return SubWindow(units=units, window_s=hi - lo, busy_s=union(intervals),
                     ops=ops, idle=idle, n_kernels=len(kernels))


def profile(run_units, units: int, tries: int = 3) -> SubWindow:
    """Profile ``run_units(units, spans)`` (which ends with the card idle)
    and reduce it; a window with dropped records is profiled again, up to
    ``tries`` windows."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            with torch.profiler.record_function(SUBWINDOW):
                run_units(units, Spans(profiled=True))
                torch.cuda.synchronize()
        sub = reduce_events(prof.profiler.kineto_results.events(), units)
        if sub is not None:
            return sub
    raise RuntimeError(f"the profiler dropped kernel records in {tries} "
                       f"sub-windows of {units} units")
