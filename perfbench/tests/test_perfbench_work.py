"""perfbench/work.py's operation and byte counts against hand counts at
tiny shapes."""

import pytest

from perfbench import cells, work

PEAKS = (work.PEAK_BYTES, work.PEAK_OPS_BF16)


def hand_bound(nbytes, nops):
    return max(nbytes / PEAKS[0], nops / PEAKS[1])


def test_bound_cv():
    # b=1, h=2, w=3, c=4: 6 pixels; two bf16 4-channel maps and one
    # 81-channel map; 81*4 multiply-adds a pixel
    assert work.bound_cv(1, 2, 3, 4) == hand_bound(
        2 * (6 * 4 * 2 + 6 * 81), 2 * 81 * 4 * 6)


def test_bound_stem_and_upconv():
    # K2 on a 4x4 RGB input to 16 channels: out 2x2
    nbytes = 2 * (16 * 3 + 4 * 16) + 4 * (9 * 16 * (3 + 32) + 48)
    assert work.bound_stem(1, 4, 4, 3, 16) == hand_bound(
        nbytes, 2 * 4 * 9 * 16 * (3 + 32))
    # K5 on a 2x2 input, 8 -> 4 channels: out 4x4
    nbytes = 2 * (4 * 8 + 16 * 4) + 4 * (16 * 8 * 4 + 4)
    assert work.bound_upconv(1, 2, 2, 8, 4) == hand_bound(
        nbytes, 2 * 4 * 8 * 16 * 4)


def conv(b, cin, cout, k, h, w, groups=1):
    """2 x multiply-adds of a conv with an (h, w) output."""
    return 2 * b * cout * (cin // groups) * k * k * h * w


def head(b, cin, h, w):
    f, c = [128, 64, 32, 16], cin
    n = 0
    for x in f:
        n += conv(b, c, c, 3, h, w, groups=c) + conv(b, c, x, 1, h, w)
        c = x
    return n + conv(b, 16, 16, 1, h, w) + conv(b, 16, 2, 3, h, w)


def flow_net_flops(b, h, w):
    enc, dec = [16, 32, 64, 128, 256], [128, 64, 32, 16]
    n, c = 0, 3
    for s, f in enumerate(enc):            # on the 2b stack
        oh, ow = h >> (s + 1), w >> (s + 1)
        n += conv(2 * b, c, f, 3, oh, ow) + 2 * conv(2 * b, f, f, 3, oh, ow)
        c = f
    dec_ch, c = [], enc[-1]
    for k, f in enumerate(dec):            # transpose convs: input size
        ih, iw = h >> (5 - k), w >> (5 - k)
        n += 2 * (2 * b) * c * f * 16 * ih * iw
        c = f + enc[-2 - k]
        dec_ch.append(c)
    levels = [(h >> 5, w >> 5, enc[-1])] + [
        (h >> (4 - i), w >> (4 - i), ch) for i, ch in enumerate(dec_ch)]
    for i, (lh, lw, ch) in enumerate(levels):
        cin = 81 + 2 * ch if i == 0 else 81 + ch + 2
        n += head(b, cin, lh, lw) + 2 * 81 * ch * b * lh * lw
    return n


@pytest.mark.parametrize("b,h,w", [(1, 64, 128), (2, 128, 64)])
def test_forward_flops_by_hand(b, h, w):
    cfg = cells.load_cell("flow_infer_b8").config
    assert work.forward_flops(cfg, b, h, w) == flow_net_flops(b, h, w)


def test_kernel_bounds_follow_the_configuration():
    flow = cells.load_cell("flow_train_b32").config
    interp = cells.load_config("pwcnet_interp")
    assert set(work.kernel_bounds(flow, 1, 64, 128, train=False)) == {
        "K1", "K2"}
    assert set(work.kernel_bounds(flow, 1, 64, 128, train=True)) == {
        "K1", "K2", "K4a", "K4b"}
    kb = work.kernel_bounds(interp, 1, 64, 128, train=True)
    assert set(kb) == {"K1", "K2", "K4a", "K4b", "K5"}
    # the interpolator's Flower runs on the 2B stack of both directions
    assert kb["K1"] == pytest.approx(
        work.kernel_bounds(flow, 2, 64, 128, train=True)["K1"])
    # K5 on the last two decoder stages: 128 -> 32 at 1/8, 64 -> 16 at 1/4
    assert kb["K5"] == work.bound_upconv(2, 8, 16, 128, 32) \
        + work.bound_upconv(2, 16, 32, 64, 16)
