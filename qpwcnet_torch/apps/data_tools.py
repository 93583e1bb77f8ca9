"""Data tools (port of qpwcnet_tpu/apps/data_tools.py): MPI-Sintel to
TFRecord shards, the shards' flow statistics, the FlyingThings3D set
file, a preview of one augmented sample and a NaN scan of a set file.

Run: python -m qpwcnet_torch.apps.data_tools convert --root <sintel> --out <dir>
     python -m qpwcnet_torch.apps.data_tools stats --shards '<glob>'
     python -m qpwcnet_torch.apps.data_tools fc3d-set --root <f3d> --out set.txt
     python -m qpwcnet_torch.apps.data_tools preview --shards '<glob>'
     python -m qpwcnet_torch.apps.data_tools nan-scan --set-file set.txt

The preview's augmentation runs on ``--device`` (the card by default).
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np


def cmd_convert(args):
    from qpwcnet_torch.data.sintel import convert_to_tfrecords

    shards = convert_to_tfrecords(args.root, args.out,
                                  pass_name=args.pass_name,
                                  n_shards=args.shards)
    print(f"wrote {len(shards)} shards to {args.out}", file=sys.stderr)


def cmd_stats(args):
    """The mean flow magnitude of each sample: their mean and largest."""
    from qpwcnet_torch.data.sintel import sintel_tfrecord_iterator

    mags = []
    for i, (_, flo) in enumerate(sintel_tfrecord_iterator(args.shards)):
        mags.append(float(np.linalg.norm(flo, axis=-1).mean()))
        if args.limit and i + 1 >= args.limit:
            break
    print(f"n={len(mags)} mean|flow|={np.mean(mags):.3f} "
          f"max={np.max(mags):.3f}")


def cmd_fc3d_set(args):
    from qpwcnet_torch.data.fchairs3d import write_set_file

    n = write_set_file(args.root, args.out, split=args.split)
    print(f"wrote {n} pairs to {args.out}", file=sys.stderr)


def cmd_preview(args):
    """A PNG grid of the first sample of the shards: both frames and the
    flow, augmented (draws from --seed) and raw."""
    import torch

    from qpwcnet_torch.data import draw_flow_augmentation
    from qpwcnet_torch.data.pipeline import preprocess_flow_batch
    from qpwcnet_torch.data.sintel import sintel_tfrecord_iterator
    from qpwcnet_torch.ops.flow_vis import flow_to_image
    from qpwcnet_torch.vis import show

    dev = torch.device(args.device)
    ims_u8, flo = next(sintel_tfrecord_iterator(args.shards))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    batch = preprocess_flow_batch(
        torch.from_numpy(ims_u8[None]).to(dev),
        torch.from_numpy(flo[None]).to(dev), (args.height, args.width),
        draw_flow_augmentation(gen, 1))

    def host(t):
        return t.float().cpu().numpy()

    show({"prv_aug": host(batch["ims"][0, ..., :3] + 0.5),
          "nxt_aug": host(batch["ims"][0, ..., 3:] + 0.5),
          "flow_aug": host(flow_to_image(batch["flo"][0])),
          "prv_raw": ims_u8[..., :3],
          "nxt_raw": ims_u8[..., 3:],
          "flow_raw": host(flow_to_image(torch.from_numpy(flo)))},
         out_path=args.out)
    print(f"wrote {args.out}", file=sys.stderr)


def cmd_nan_scan(args):
    """Count the samples of a set file that hold a NaN."""
    from qpwcnet_torch.data.fchairs3d import fc3d_iterator

    bad = total = 0
    for ims, flo in fc3d_iterator(args.set_file, shuffle=False):
        total += 1
        if np.isnan(flo).any() or np.isnan(ims).any():
            bad += 1
        if args.limit and total >= args.limit:
            break
    print(f"{bad}/{total} samples contain NaNs")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("convert")
    c.add_argument("--root", required=True)
    c.add_argument("--out", required=True)
    c.add_argument("--pass-name", default="final")
    c.add_argument("--shards", type=int, default=32)
    c.set_defaults(fn=cmd_convert)

    s = sub.add_parser("stats")
    s.add_argument("--shards", required=True)
    s.add_argument("--limit", type=int, default=0)
    s.set_defaults(fn=cmd_stats)

    f = sub.add_parser("fc3d-set")
    f.add_argument("--root", required=True)
    f.add_argument("--out", required=True)
    f.add_argument("--split", default="TRAIN")
    f.set_defaults(fn=cmd_fc3d_set)

    v = sub.add_parser("preview")
    v.add_argument("--shards", required=True)
    v.add_argument("--out", default=str(Path(tempfile.gettempdir())
                                        / "qpwcnet_torch_preview.png"))
    v.add_argument("--height", type=int, default=256)
    v.add_argument("--width", type=int, default=512)
    v.add_argument("--seed", type=int, default=0)
    v.add_argument("--device", default="cuda")
    v.set_defaults(fn=cmd_preview)

    n = sub.add_parser("nan-scan")
    n.add_argument("--set-file", required=True)
    n.add_argument("--limit", type=int, default=0)
    n.set_defaults(fn=cmd_nan_scan)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
