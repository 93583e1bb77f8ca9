"""The work of a forward and of the hand-written kernels, counted from
the shapes of the plain reference, never from what the program calls.

  * :func:`forward_flops`: ``FlopCounterMode`` over the reference's
    forward on the ``meta`` device (every convolution, 2 operations a
    multiply-add, padding taps counted as the convolution computes
    them), plus 2 x 81 x C operations a pixel for each cost volume,
    which the counter does not see (a product and a sum per offset and
    channel). A train step is counted as 3 forwards (each convolution's
    and cost volume's backward: its two input gradients).
  * :func:`kernel_bounds`: the least time the card could take for each
    hand-written kernel (K1-K5) a batch or step, max(bytes moved once /
    3.35 TB/s, bf16 operations / 989 TFLOP/s), summed over its launches
    at the cell's own shapes. The byte and operation formulas are frozen
    copies of the measured package's smoke test's (``bound_cv``,
    ``bound_stem``, ``bound_upconv``).

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W limit.
"""

from __future__ import annotations

import torch

from perfbench.reference import models

PEAK_BYTES = 3.35e12
PEAK_OPS_BF16 = 989e12


def bound(nbytes: float, nops: float) -> float:
    """Seconds: the larger of moving nbytes through device memory and
    doing nops bf16 operations on the tensor cores."""
    return max(nbytes / PEAK_BYTES, nops / PEAK_OPS_BF16)


def bound_cv(b, h, w, c, extra_bytes=0):
    """K1, K3, K4a, K4b at one level, bf16: two (b, h, w, c) maps and one
    (b, h, w, 81) map moved once; 81·c multiply-adds a pixel."""
    px = b * h * w
    return bound(2 * (2 * px * c + 81 * px) + extra_bytes, 2 * 81 * c * px)


def stem_bytes(b, h, w, cin, cout):
    """K2: the bf16 input and half-size output, the float32 weights and
    biases."""
    return (2 * (b * h * w * cin + b * (h // 2) * (w // 2) * cout)
            + 4 * (9 * cout * (cin + 2 * cout) + 3 * cout))


def bound_stem(b, h, w, cin, cout):
    """K2 on an (h, w) input: its bytes; the three 3x3 convs'
    multiply-adds."""
    px = b * (h // 2) * (w // 2)
    return bound(stem_bytes(b, h, w, cin, cout),
                 2 * px * 9 * cout * (cin + 2 * cout))


def upconv_bytes(b, h, w, ci, co):
    """K5: the bf16 input and 2x output, the float32 weights and bias."""
    return 2 * (b * h * w * ci + b * 4 * h * w * co) + 4 * (16 * ci * co + co)


def bound_upconv(b, h, w, ci, co):
    """K5 on an (h, w) input: its bytes; 4 taps of ci multiply-adds an
    output value."""
    return bound(upconv_bytes(b, h, w, ci, co),
                 2 * 4 * ci * b * 4 * h * w * co)


def flower_levels(cfg: dict, b: int, h: int, w: int):
    """(batch, h, w, channels) of each cost volume, coarsest first: the
    Flower runs on the B pairs, or the interpolator's 2B directions."""
    enc, dec = cfg["encoder_filters"], cfg["decoder_filters"]
    dec_ch = [f + e for f, e in zip(dec, enc[-2::-1])]
    bf = b if cfg["model"] == "flow" else 2 * b
    n = len(enc)
    out = [(bf, h >> n, w >> n, enc[-1])]
    for i, c in enumerate(dec_ch):
        out.append((bf, h >> (n - 1 - i), w >> (n - 1 - i), c))
    return out


def kernel_bounds(cfg: dict, b: int, h: int, w: int,
                  train: bool) -> dict[str, float]:
    """Seconds of bound a forward (or train step) for each kernel that
    the configuration runs, by the trace's category names."""
    prog = cfg["program"]
    enc, dec = cfg["encoder_filters"], cfg["decoder_filters"]
    out: dict[str, float] = {}

    def add(cat, s):
        out[cat] = out.get(cat, 0.0) + s

    levels = flower_levels(cfg, b, h, w)
    for i, (bf, lh, lw, c) in enumerate(levels):
        fast = prog.get("cv_impl") == "fast" and i == len(levels) - 1
        # K3 also reads the float32 flow
        add("K3" if fast else "K1",
            bound_cv(bf, lh, lw, c, extra_bytes=8 * bf * lh * lw if fast
                     else 0))
        if train:
            add("K4a", bound_cv(bf, lh, lw, c))
            add("K4b", bound_cv(bf, lh, lw, c))
    chans = [3, *enc]
    for s in range(prog.get("stem_stages", 0)):
        add("K2", bound_stem(2 * b, h >> s, w >> s, chans[s], chans[s + 1]))
    n = len(dec)
    dec_ch = [f + e for f, e in zip(dec, enc[-2::-1])]
    for k in range(n - prog.get("upconv_stages", 0), n):
        ci = enc[-1] if k == 0 else dec_ch[k - 1]
        sh = len(enc) - k
        add("K5", bound_upconv(2 * b, h >> sh, w >> sh, ci, dec[k]))
    return out


def forward_flops(cfg: dict, b: int, h: int, w: int) -> float:
    """Operations of one forward of the configuration's model on a
    (b, h, w, 6) batch."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        model = models.build(cfg)
        x = torch.empty(b, h, w, 6)
        counter = FlopCounterMode(display=False)
        with torch.no_grad(), counter:
            model(x)
    d = 2 * cfg["search_range"] + 1
    cv = sum(2 * d * d * c * bf * lh * lw
             for bf, lh, lw, c in flower_levels(cfg, b, h, w))
    return float(counter.get_total_flops()) + cv
