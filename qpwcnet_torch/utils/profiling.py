"""Profiling and tracing (port of qpwcnet_tpu/utils/profiling.py), and
the device-time breakdown of a step with ``torch.profiler``.

  * :func:`trace` — ``torch.profiler`` over the block (CPU and, where
    there is one, CUDA activity) -> a Chrome/Perfetto trace in a
    directory (JAX's writes an XProf trace);
  * :func:`time_fn` — the median time of a call (CUDA events on the
    card, ``perf_counter`` on the CPU);
  * :func:`time_fn_chained` — the time a call of a serial chain whose
    every input depends on the previous output;
  * :func:`cost_analysis` — the flops (``FlopCounterMode``, with the
    formulas the kernels' custom ops register) and the bytes each ATen
    op reads and writes;
  * :func:`summarize_model` — the parameter-count tree;
  * :func:`breakdown` — device time by kernel category.
"""

from __future__ import annotations

import contextlib
import os
import re
import statistics
import time
from typing import Callable

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

# (category, pattern of the demangled kernel name); the first match wins
CATEGORIES = (
    # K1: the float32 body (CUDA cores) and the bf16 body (tensor cores)
    ("K1", r"correlate_kernel<[^>]*, false>|cost_volume_mma_kernel"),
    # K3: the float32 body (CUDA cores) and the bf16 body (tensor cores)
    ("K3", r"correlate_kernel<[^>]*, true>|warp_cv_mma_kernel"),
    # K4a, K4b: the float32 body (CUDA cores) and the bf16 body (tensor
    # cores)
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


def category(name: str) -> str:
    for cat, pattern in CATEGORIES:
        if re.search(pattern, name):
            return cat
    return "other"


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def breakdown(fn, n: int = 3, warmup: int = 3) -> dict:
    """Profile n calls of fn() after warm-up. Returns per-call {'kernels',
    'wall_ms', 'busy_ms', 'busy_share', 'by_category': {cat: ms}}."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device events")
    by_cat: dict[str, float] = {}
    for e in kernels:
        c = category(e.name)
        by_cat[c] = by_cat.get(c, 0.0) + e.time_range.elapsed_us() / 1e3 / n
    busy = _union_us((e.time_range.start, e.time_range.end)
                     for e in kernels) / 1e3 / n
    return {"kernels": len(kernels) / n, "wall_ms": wall, "busy_ms": busy,
            "busy_share": busy / wall, "by_category": by_cat}


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the block with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is present) and write it into ``log_dir`` as a
    Chrome/Perfetto trace (``<host>_<pid>.<ms>.pt.trace.json``, the
    TensorBoard plugin's layout). Yields the profiler."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def _on_card(tree) -> bool:
    return any(isinstance(t, torch.Tensor) and t.is_cuda
               for t in pytree.tree_leaves(tree))


class _Clock:
    """Host seconds on the CPU; on the card, CUDA events on the current
    stream, read after a synchronize."""

    def __init__(self, card: bool):
        self.card = card

    def start(self):
        if self.card:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def seconds_since(self, t0) -> float:
        if self.card:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            return t0.elapsed_time(end) / 1e3
        return time.perf_counter() - t0


def time_fn(fn: Callable, *args, iters: int = 20, warmup: int = 2) -> float:
    """The median time of ``fn(*args)`` over ``iters`` calls after
    ``warmup``, in seconds: CUDA events around each call where the
    arguments or the output lie on the card, ``perf_counter`` around each
    call on the CPU."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    clock = _Clock(_on_card((args, out)))
    if clock.card:
        torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = clock.start()
        fn(*args)
        times.append(clock.seconds_since(t0))
    return float(statistics.median(times))


def time_fn_chained(fn: Callable, x0, iters: int = 10) -> float:
    """Seconds a call of a single-argument ``fn`` in a serial chain: each
    input is the previous one times ``1 + 7.8e-3 * (1 + 0.1 * tanh(mean of
    the first output leaf))``, a perturbation that survives bf16 rounding
    and makes every call wait for the one before. ``x0`` and the output
    may be tensors or pytrees of them; only floating leaves are scaled.
    One call first warms up."""
    out = fn(x0)
    clock = _Clock(_on_card((x0, out)))
    if clock.card:
        torch.cuda.synchronize()
    x = x0
    t0 = clock.start()
    for _ in range(iters):
        out = fn(x)
        leaf = pytree.tree_leaves(out)[0]
        scale = 1.0 + 7.8e-3 * (
            1.0 + 0.1 * torch.tanh(torch.mean(leaf.float())))
        x = pytree.tree_map(
            lambda a: a * scale.to(a.dtype) if a.is_floating_point() else a,
            x)
    return clock.seconds_since(t0) / iters


class _BytesAccessed(TorchDispatchMode):
    """Sums the bytes of every tensor each ATen op reads and writes (its
    tensor arguments and results); views move no bytes and are left
    out."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.total += sum(
                t.numel() * t.element_size()
                for t in pytree.tree_leaves((args, kwargs, out))
                if isinstance(t, torch.Tensor))
        return out


def cost_analysis(fn: Callable, *args) -> dict:
    """{'flops', 'bytes accessed'} of one call of ``fn(*args)``, run
    eagerly under ``torch.no_grad``.

    flops: ``torch.utils.flop_counter.FlopCounterMode`` (the convolutions
    and matrix products, and the formula each kernel's custom op
    registers, ``ops/cuda/cost_volume_kernel.py``, ``warp_cv_kernel.py``;
    on the CPU the kernels' plain versions run and add none). bytes
    accessed: each ATen op's tensor inputs and outputs, summed, as XLA
    counts an op's bytes, but over the unfused ops, so above the figure
    of a fused XLA program."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    nbytes = _BytesAccessed()
    with torch.no_grad(), counter, nbytes:
        fn(*args)
    return {"flops": float(counter.get_total_flops()),
            "bytes accessed": float(nbytes.total)}


def summarize_model(model: torch.nn.Module, indent: int = 0) -> str:
    """The parameter-count tree of ``model`` from ``named_parameters``
    (each module with its total, each parameter with its shape and
    count, names sorted), ending ``TOTAL: N params``."""
    tree: dict = {}
    for name, p in model.named_parameters():
        node = tree
        *parents, leaf = name.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = p

    def walk(node, name, depth):
        if isinstance(node, dict):
            total, sub = 0, []
            for k in sorted(node):
                n, s = walk(node[k], k, depth + 1)
                total += n
                sub.extend(s)
            return total, [f"{'  ' * depth}{name or 'model'}: {total:,}"] + sub
        n = node.numel()
        return n, [f"{'  ' * depth}{name}: {tuple(node.shape)} = {n:,}"]

    total, lines = walk(tree, "", indent)
    lines.append(f"TOTAL: {total:,} params")
    return "\n".join(lines)
