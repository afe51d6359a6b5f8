"""Pack an image folder or .lst file into RecordIO (ref: the repository's
``tools/im2rec.py``).

Usage:
  python -m mxnet_tpu_torch.tools.im2rec PREFIX ROOT --list [--recursive]
  python -m mxnet_tpu_torch.tools.im2rec PREFIX ROOT --quality 95 \\
      [--resize N] [--pack-label] [--native]

Two phases like the reference: `--list` generates PREFIX.lst
(idx\\tlabel\\trelpath); without it, packs PREFIX.lst into PREFIX.rec +
PREFIX.idx (JPEG-encoded, readable by ImageRecordIter incl. the native
C++ pipeline).  Its .lst, .rec and .idx files are byte-identical to the
repository tool's on the same folder.
"""
import argparse
import os

from ..io import recordio

EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def make_list(prefix, root, recursive=False, train_ratio=1.0):
    items = []
    if recursive:
        label = 0
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            for fn in sorted(os.listdir(path)):
                if fn.lower().endswith(EXTS):
                    items.append((os.path.join(folder, fn), label))
            label += 1
    else:
        for fn in sorted(os.listdir(root)):
            if fn.lower().endswith(EXTS):
                items.append((fn, 0))
    with open(prefix + ".lst", "w") as f:
        for i, (rel, label) in enumerate(items):
            f.write(f"{i}\t{label}\t{rel}\n")
    print(f"wrote {len(items)} entries to {prefix}.lst")


def pack(prefix, root, quality=95, resize=0, color=1, pack_label=False,
         native=False):
    import numpy as np
    from PIL import Image

    if native:
        # record/index writing through src/recordio.cc (the im2rec.cc
        # role); JPEG encode stays in Python — the bytes are identical
        rec = recordio.NativeIndexedRecordIO(prefix + ".idx",
                                             prefix + ".rec", "w")
    else:
        rec = recordio.MXIndexedRecordIO(prefix + ".idx",
                                         prefix + ".rec", "w")
    n = 0
    with open(prefix + ".lst") as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) < 3:
                continue
            idx, rel = int(parts[0]), parts[-1]
            if pack_label:
                # full float label vector (detection et al.; ref:
                # im2rec.py --pack-label)
                label = np.array([float(v) for v in parts[1:-1]],
                                 np.float32)
            else:
                label = float(parts[1])
            img = Image.open(os.path.join(root, rel))
            img = img.convert("RGB" if color else "L")
            if resize:
                short = min(img.size)
                scale = resize / short
                img = img.resize((int(img.size[0] * scale),
                                  int(img.size[1] * scale)))
            rec.write_idx(idx, recordio.pack_img(
                recordio.IRHeader(0, label, idx, 0), np.asarray(img),
                quality=quality, img_fmt=".jpg"))
            n += 1
    rec.close()
    print(f"packed {n} images into {prefix}.rec")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("prefix")
    ap.add_argument("root")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--recursive", action="store_true")
    ap.add_argument("--quality", type=int, default=95)
    ap.add_argument("--resize", type=int, default=0)
    ap.add_argument("--color", type=int, default=1)
    ap.add_argument("--pack-label", action="store_true",
                    help="pack every .lst field between idx and path as "
                         "a float label vector (detection labels)")
    ap.add_argument("--native", action="store_true",
                    help="write records through the native C++ recordio "
                         "writer (ref: tools/im2rec.cc)")
    args = ap.parse_args()
    if args.list:
        make_list(args.prefix, args.root, args.recursive)
    else:
        if not os.path.exists(args.prefix + ".lst"):
            make_list(args.prefix, args.root, recursive=True)
        pack(args.prefix, args.root, args.quality, args.resize, args.color,
             pack_label=args.pack_label, native=args.native)


if __name__ == "__main__":
    main()
