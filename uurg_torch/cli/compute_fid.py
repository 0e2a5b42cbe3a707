"""SD FID CLI, the flags of ``cli/compute_fid.py``
(SD/eval-scripts/compute-fid.py) plus ``--device``: the FID between a real
image folder (a subdirectory a class, ``--class_to_forget`` left out) and a
folder of generated images.

    python -m uurg_torch.cli.compute_fid --folder_path IMAGES \\
        --real_path IMAGENETTE --class_to_forget 6 \\
        --inception_weights pt_inception-2015-12-05.pth

Both sides are read at ``--image_size`` (the ADM center crop) and go
through InceptionV3's pool features on the card in ``--batch_size``
chunks; the Fréchet distance is computed on the host.
``--inception_weights`` is the JAX package's flax-layout ``.npz``
(``cli/convert_inception.py`` writes it) or pytorch-fid's
``pt_inception`` ``.pth``, told apart by suffix; without it the
InceptionV3 is a seeded random init and the FID is not comparable to
published numbers.
"""
from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--folder_path", type=str, required=True,
                   help="generated images folder")
    p.add_argument("--real_path", type=str, required=True,
                   help="real image folder (Imagenette subset layout)")
    p.add_argument("--class_to_forget", type=int, default=6,
                   help="class EXCLUDED from the real set (remain FID)")
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--inception_weights", type=str, default="",
                   help="InceptionV3 weights: the JAX package's .npz or "
                        "pytorch-fid's pt_inception .pth")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a GPU) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from uurg_torch.core.device import resolve_device
    from uurg_torch.data.lazy import LazyImageFolder
    from uurg_torch.data.splits import class_forget_split
    from uurg_torch.eval.generative import compute_fid
    from uurg_torch.eval.inception import load_inception, make_extractor

    device = resolve_device(args.device)
    extractor = make_extractor(load_inception(args.inception_weights)
                               .to(device))

    real_ds = LazyImageFolder(args.real_path, args.image_size)
    real_ds, _ = class_forget_split(real_ds, args.class_to_forget)
    fake_paths = np.asarray(sorted(
        os.path.join(args.folder_path, f)
        for f in os.listdir(args.folder_path)
        if f.lower().endswith((".png", ".jpg", ".jpeg"))))
    fake_ds = LazyImageFolder("", args.image_size, paths=fake_paths,
                              labels=np.zeros(len(fake_paths), np.int64))

    def pool_feats(ds):
        feats = []
        for i in range(0, len(ds), args.batch_size):
            x, _ = ds.get_batch(np.arange(i, min(i + args.batch_size,
                                                 len(ds))))
            feats.append(extractor((x * 255).astype(np.uint8))[0])
        return np.concatenate(feats)

    t0 = time.perf_counter()
    real, fake = pool_feats(real_ds), pool_feats(fake_ds)
    t1 = time.perf_counter()
    fid = compute_fid(real, fake)
    logging.info("features of %d real + %d generated images: %.3f s; "
                 "Fréchet distance on the host: %.3f s", len(real),
                 len(fake), t1 - t0, time.perf_counter() - t1)
    print(f"FID: {fid}")


if __name__ == "__main__":
    main()
