"""Which operand layouts and shapes ``torch._int_mm`` (cuBLASLt's int8
GEMM) takes on the card: every row count from 17 to 129 and a few large
ones, at the inner and output dims of the int8 convs, with the second
operand row-major (cuBLASLt's NN GEMM) and column-major (its TN GEMM);
each product checked against the CPU's int32 one.

    python -m qpwcnet_torch.utils.int_mm_layouts   # on a CUDA card

Prints, for each layout, the shapes that raised or computed wrong (the
reason ``quantize/int8.py:int8_matmul`` passes the kernel matrix
column-major).
"""

from __future__ import annotations

import torch

ROWS = list(range(17, 130)) + [1024, 3584, 3585, 4097]
INNER = (32, 64, 144, 576, 1024)
OUTER = (8, 16, 32, 128)


def sweep(dev: torch.device, column_major: bool) -> list:
    """[(M, K, N, what went wrong)] of one layout."""
    gen = torch.Generator(device=dev).manual_seed(0)
    bad = []
    for m in ROWS:
        for k in INNER:
            for n in OUTER:
                a = torch.randint(-128, 128, (m, k), generator=gen,
                                  device=dev, dtype=torch.int8)
                b = torch.randint(-128, 128, (k, n), generator=gen,
                                  device=dev, dtype=torch.int8)
                if column_major:
                    b = b.t().contiguous().t()
                try:
                    out = torch._int_mm(a, b)
                except RuntimeError as e:
                    bad.append((m, k, n, str(e).splitlines()[0][:60]))
                    continue
                if not torch.equal(out.cpu(), a.cpu().int() @ b.cpu().int()):
                    bad.append((m, k, n, "wrong product"))
    return bad


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("int_mm_layouts: needs a CUDA card")
    dev = torch.device("cuda", 0)
    print(f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}")
    for column_major in (False, True):
        bad = sweep(dev, column_major)
        name = "column-major b (TN)" if column_major else "row-major b (NN)"
        rows = sorted({m for m, *_ in bad})
        print(f"{name}: {len(bad)} of "
              f"{len(ROWS) * len(INNER) * len(OUTER)} shapes failed; rows "
              f"{rows}; e.g. {bad[:3]}")


if __name__ == "__main__":
    main()
