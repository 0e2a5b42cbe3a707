"""Pre-encode an image folder into VAE latent shards for the DiT workload:
the flags of ``cli/encode_latents.py`` plus ``--device``.

    python -m uurg_torch.cli.encode_latents --image_folder IMAGES \\
        --out LATENTS/shard --shard_size 4096

The reference encodes every batch through the frozen VAE inside the
training loop (DiT/forget.py:265-267); encoding once takes that forward out
of every step (the latents are 48 times smaller than the images). Images
are decoded per batch (:class:`~uurg_torch.data.lazy.LazyImageFolder`, a
subdirectory a class, the ADM center crop), mapped to [-1, 1] and encoded
by the VAE (``--vae_ckpt``: a CompVis first-stage ``.ckpt``/``.pth`` or the
port's own ``.pt``; a seeded init when empty) as draws from its posterior,
one generator seeded with ``--seed`` for all batches. Writes one npz of
``latents`` (N, H/8, W/8, 4) float32 NHWC and ``labels``, or with
``--shard_size`` the ``<out>-NNNNN.npz`` shards that
``forget --data-path`` streams.
"""
from __future__ import annotations

import argparse
import logging


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--image_folder", type=str, required=True)
    p.add_argument("--out", type=str, required=True,
                   help="output npz path (no --shard_size) or shard prefix")
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--shard_size", type=int, default=0,
                   help="items per shard; 0 = single npz file")
    p.add_argument("--vae_ckpt", type=str, default="",
                   help="VAE weights: a CompVis first-stage .ckpt/.pth or "
                        "the port's own .pt; a seeded init when empty")
    p.add_argument("--classes", type=str, nargs="*", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a GPU) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    import numpy as np
    import torch

    from uurg_torch.cli.dit_common import build_vae
    from uurg_torch.data.lazy import LazyImageFolder, write_latent_shards

    ds = LazyImageFolder(args.image_folder, args.image_size,
                         class_names=args.classes)
    vae = build_vae(args.vae_ckpt, args.device)
    dev = next(vae.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def encoded_batches():
        for i in range(0, len(ds), args.batch_size):
            x, y = ds.get_batch(np.arange(i, min(i + args.batch_size,
                                                 len(ds))))
            with torch.inference_mode():
                z = vae.encode(torch.from_numpy(x * 2.0 - 1.0).to(dev),
                               generator=gen)
            if (i // args.batch_size) % 20 == 0:
                logging.info("%d / %d", i, len(ds))
            yield z.cpu().numpy(), y

    if args.shard_size > 0:
        paths = write_latent_shards(args.out, encoded_batches(),
                                    args.shard_size)
        print(f"wrote {len(paths)} shards: {paths[0]} ..")
    else:
        zs, ys = zip(*encoded_batches())
        np.savez_compressed(args.out, latents=np.concatenate(zs),
                            labels=np.concatenate(ys))
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
