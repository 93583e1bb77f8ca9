"""One run of one cell of the benchmark, on the card it is started on.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (the kernels' build on a fresh
checkout, the seeded weights and inputs made on the card, the warm-up)
counts from the start of this process to the start of the window and is
reported as ``setup_s``. The window then runs the cell's traffic for
``--seconds``. With ``--trace 1`` a short sub-window after it is
profiled and the cell's per-layer metrics are read
(perfbench/metrics/); otherwise its end-to-end metrics are reported.
Last, with the program's state freed, what the window produced is judged
against the plain reference (perfbench/reference/), and each number
compared is printed beside its limit: as the last lines of standard
error, and in the result, the last line of standard output, as one JSON
object.

Exits non-zero with no result where there is no CUDA card (or fewer than
the cell asks for), or where JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from perfbench import cells  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "qpwcnet_tpu"}


def cache_dirs(root) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = os.path.join(root, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def execute(cell, seed: int, seconds: float, traced: bool, device,
            system: str = "program", t_start: float = None) -> dict:
    """Set-up, the window, the traced sub-window and the check of one run;
    returns the result's fields (without ``device``'s name)."""
    import torch

    from perfbench import trace
    from perfbench.compare import verdict

    t0 = T_START if t_start is None else t_start
    log(f"imports and card {time.perf_counter() - t0:.3f} s")
    runner = cell.kind.Runner(cell, seed, device, system)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s")
    win = runner.window(seconds)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"perfbench: loaded {', '.join(found)}")
    mem = torch.cuda.max_memory_allocated(device) if cuda else 0
    out = {"attempted": win.units}
    if traced:
        sub = trace.profile(runner.run_units, cell.params["profile_units"])
        ctx = runner.context(win, sub)
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        out["breakdown"] = annotated_breakdown(sub, ctx)
        out["busy_s"], out["window_s"] = sub.busy_s, sub.window_s
    else:
        values = dict(runner.end_to_end(win), setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    out["metrics"] = metrics
    out["memory_peak_bytes"] = mem
    t_check = time.perf_counter()
    numbers = runner.check()
    log(f"check against the reference {time.perf_counter() - t_check:.3f} s")
    limits = cell.workload["limits"]
    out["failed"] = sum(v for k, v in numbers.items()
                        if k.startswith("nonfinite"))
    out["correct"] = verdict(numbers, limits)
    out["checks"] = {k: {"value": v, "limit": limits.get(k)}
                     for k, v in numbers.items()}
    out["raw"] = getattr(runner, "raw", None)
    return out


def log(msg: str) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


def annotated_breakdown(sub, ctx) -> dict:
    """The sub-window's breakdown, each hand-written kernel's entry named
    with its own share of its roofline."""
    from perfbench import readers

    bd = sub.breakdown()
    for entry in bd["device_ops"]:
        cat = entry[0].split(":")[0]
        share = readers.kernel_roofline_pct(ctx, cat)
        if share is not None:
            entry[0] += f" (roofline {share:.2f}%)"
    return bd


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache_dirs(str(cells.ROOT))
    cell = cells.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA card(s)",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = execute(cell, args.seed, args.seconds, bool(args.trace), device)
    found = forbidden_modules()
    if found:
        print(f"perfbench: loaded {', '.join(found)}", file=sys.stderr)
        return 3
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": cell.chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    if args.trace:
        dev["busy_s"], dev["window_s"] = out["busy_s"], out["window_s"]
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"],
              "device": dev}
    if args.trace:
        result["breakdown"] = out["breakdown"]
    result["checks"] = out["checks"]
    sys.stdout.flush()
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
