"""Whether the bf16 train steps' gradients are the same from run to run on
the card, and what the reproducible backwards cost.

    python -m qpwcnet_torch.utils.determinism        # on a CUDA card

Three settings of the steps' backward:
  * "atomics": the warp's image gradient by four ``index_add_`` calls and
    the 2x bilinear upsampling's by ``F.interpolate``'s own backward, both
    scatters of atomics on the card (the port's backwards before they were
    made reproducible);
  * "sorted": the port's own (``ops/warp.py:_scatter_rows``, one sorted
    ``index_put_``; ``ops/resize.py:_Upsample2x``, the transpose as
    slices);
  * "sorted + cudnn": also ``torch.backends.cudnn.deterministic``.
For each, the bf16 flow train step at 256x512 b16 (plain, exact and
'fast' models) and the bf16 pretraining step at 256x512 b8 (plain and
exact) run twice on one batch at learning rate 0, each run on a fresh
model with 'unit' flow heads (non-zero flows), and the gradients that
differ between the two runs are counted. Then, for the atomics and the
sorted backwards:
  * the two backwards alone, at the flow step's finest level (the warp's
    d_img of a (16, 128, 256, 32) bf16 map; the upsampling's backward of
    a (16, 2, 256, 512) bf16 flow gradient): CUDA-event time a call over
    20 chained calls after 3 warm-up calls;
  * the host's waits on the card in one exact bf16 flow step and one
    pretraining step: the synchronising CUDA runtime calls in a
    torch.profiler trace;
  * the exact bf16 flow step and the exact bf16 pretraining step,
    parameters updated, in turns (atomics, sorted, sorted, atomics, twice;
    CUDA events, median of 10 after 2 warm-up steps; cuDNN as it
    defaults).
"""

from __future__ import annotations

import contextlib
import statistics
import subprocess
import sys

import torch

from qpwcnet_torch.models import pwcnet
from qpwcnet_torch.ops import resize, warp

FLOW_MODES = {"plain": dict(cv_impl="plain"),
              "exact": dict(cv_impl="auto", stem_stages=2),
              "fast": dict(cv_impl="fast", stem_stages=2)}
INTERP_MODES = {"plain": dict(cv_impl="plain"),
                "exact": dict(stem_stages=2, upconv_stages=2)}


def _atomic_scatter(n, idx, terms):
    """``ops/warp.py:_scatter_rows`` as ``index_add_`` calls in the terms'
    dtype: on the card a scatter of atomics."""
    acc = torch.zeros((n, terms[0].shape[1]), dtype=terms[0].dtype,
                      device=terms[0].device)
    for i, t in zip(idx, terms):
        acc.index_add_(0, i, t)
    return acc


def _atomic_upsample(x, scale=1.0):
    """``upsample2x_bilinear_nchw`` with ``F.interpolate``'s backward."""
    y = resize._up2x(x)
    return y * scale if scale != 1.0 else y


@contextlib.contextmanager
def setting(name: str):
    """The backwards of ``name`` ("atomics", "sorted", "sorted + cudnn"),
    restored after."""
    saved = (warp._scatter_rows, pwcnet.upsample2x_bilinear_nchw,
             torch.backends.cudnn.deterministic)
    if name == "atomics":
        warp._scatter_rows = _atomic_scatter
        pwcnet.upsample2x_bilinear_nchw = _atomic_upsample
    torch.backends.cudnn.deterministic = name == "sorted + cudnn"
    try:
        yield
    finally:
        (warp._scatter_rows, pwcnet.upsample2x_bilinear_nchw,
         torch.backends.cudnn.deterministic) = saved


def _flow_batch(dev):
    from qpwcnet_torch.data import preprocess_flow_batch, synthetic_flow_batch

    gen = torch.Generator(device=dev).manual_seed(0)
    ims, flo = synthetic_flow_batch(gen, 16, 256, 512)
    return preprocess_flow_batch(ims, flo, out_hw=(256, 512))


def _interp_batch(dev):
    from qpwcnet_torch.data import (
        preprocess_triplet_batch,
        synthetic_triplet_batch,
    )

    gen = torch.Generator(device=dev).manual_seed(0)
    return preprocess_triplet_batch(
        None, *synthetic_triplet_batch(gen, 8, 256, 512), augment=False)


def _grads(kind: str, kw: dict, batch, dev) -> dict:
    """One bf16 step at learning rate 0 on a fresh 'unit'-head model: its
    gradients by parameter name."""
    from qpwcnet_torch.models import build_flow_net, build_interpolator
    from qpwcnet_torch.train import (
        make_flow_train_step,
        make_interp_train_step,
        plain_optimizer,
    )

    build = build_flow_net if kind == "flow" else build_interpolator
    step = make_flow_train_step() if kind == "flow" else \
        make_interp_train_step()
    model = build(0, dev, dtype=torch.bfloat16, head_scale="unit", **kw)
    step(model, plain_optimizer(model, 0.0), batch)
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _exact_step(kind: str, batch, dev):
    """The exact bf16 step, parameters updated, as a closure."""
    from qpwcnet_torch.models import build_flow_net, build_interpolator
    from qpwcnet_torch.train import (
        create_interp_train_state,
        make_flow_train_step,
        make_interp_train_step,
        plain_optimizer,
    )

    kw = dict(dtype=torch.bfloat16, head_scale="unit")
    if kind == "flow":
        model = build_flow_net(0, dev, **kw, **FLOW_MODES["exact"])
        opt, step = plain_optimizer(model, 1e-4), make_flow_train_step(0.0)
    else:
        model = build_interpolator(0, dev, **kw, **INTERP_MODES["exact"])
        opt = create_interp_train_state(model, 1e-4)
        step = make_interp_train_step()
    return lambda: step(model, opt, batch)


def _chain_ms(fn, n: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def _backwards(dev) -> dict:
    """The warp's d_img and the upsampling's backward at the flow step's
    finest level, as closures (each looks its function up when called,
    so that :func:`setting` applies)."""
    g = torch.Generator(device=dev).manual_seed(1)
    shape = (16, 128, 256, 32)
    img = torch.randn(shape, generator=g, device=dev).bfloat16()
    flow = 2.0 * torch.randn(shape[:3] + (2,), generator=g, device=dev)
    gi = torch.randn(shape, generator=g, device=dev).bfloat16()
    x = torch.randn((16, 2, 128, 256), generator=g, device=dev).bfloat16()
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_()
    gx = torch.randn((16, 2, 256, 512), generator=g, device=dev).bfloat16()
    gx = gx.contiguous(memory_format=torch.channels_last)
    return {
        "warp d_img": lambda: warp._warp_img_grad(img, flow, gi),
        "upsample backward": lambda: torch.autograd.grad(
            pwcnet.upsample2x_bilinear_nchw(x, 2.0), x, gx),
    }


SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")


def _syncs(fn) -> dict:
    """The synchronising CUDA runtime calls of one fn() call, by name
    (cudaMemcpy: the blocking copies, not cudaMemcpyAsync)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out: dict[str, int] = {}
    for e in prof.events():
        name = e.name
        if any(name == s or name.startswith(s + "(") for s in SYNCS):
            out[name] = out.get(name, 0) + 1
    return out


def _step_ms(fn, n: int = 10, warmup: int = 2) -> float:
    """Median CUDA-event time of fn(), one step."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("determinism needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batches = {"flow": _flow_batch(dev), "interp": _interp_batch(dev)}
    cases = [("flow", m, kw) for m, kw in FLOW_MODES.items()] + \
        [("interp", m, kw) for m, kw in INTERP_MODES.items()]
    names = ("atomics", "sorted", "sorted + cudnn")
    print("| bf16 step, model | " + " | ".join(names) + " |")
    print("|---" * (len(names) + 1) + "|")
    for kind, mode, kw in cases:
        cells = []
        for name in names:
            with setting(name):
                a, b = (_grads(kind, kw, batches[kind], dev)
                        for _ in range(2))
            differ = sum(not torch.equal(a[k], b[k]) for k in a)
            cells.append(f"{differ} of {len(a)} differ")
            del a, b
            torch.cuda.empty_cache()
        print(f"| {kind} {mode} | " + " | ".join(cells) + " |", flush=True)
    pieces = _backwards(dev)
    for name in ("atomics", "sorted", "sorted", "atomics"):
        with setting(name):
            print(f"{name}: " + ", ".join(
                f"{k} {_chain_ms(fn):.4f} ms" for k, fn in pieces.items()),
                flush=True)
    del pieces
    for kind in ("flow", "interp"):
        for name in ("atomics", "sorted"):
            with setting(name):
                print(f"{kind} step exact bf16, {name}: host waits "
                      f"{_syncs(_exact_step(kind, batches[kind], dev))}",
                      flush=True)
            torch.cuda.empty_cache()
    for kind in ("flow", "interp"):
        t = {"atomics": [], "sorted": []}
        for name in ("atomics", "sorted", "sorted", "atomics") * 2:
            with setting(name):
                t[name].append(_step_ms(_exact_step(kind, batches[kind],
                                                    dev)))
            torch.cuda.empty_cache()
        cells = [f"{k} {statistics.mean(v):.3f} ("
                 + ", ".join(f"{x:.3f}" for x in v) + ")"
                 for k, v in t.items()]
        print(f"{kind} step exact bf16, ms (turns): " + "; ".join(cells),
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
