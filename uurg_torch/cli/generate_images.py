"""SD image-generation CLI, the flags of ``cli/generate_images.py``
(SD/eval-scripts/generate-images.py): for each row of a prompt CSV
(``case_number``, ``prompt``, ``evaluation_seed``) sample ``--num_samples``
images with classifier-free guidance and write ``{case_number}_{i}.png``.

    python -m uurg_torch.cli.generate_images --prompts_path prompts.csv \\
        --save_path IMAGES --ckpt_path RUN/final.pt --sampler lms

``--ckpt_path`` is a CompVis ``.ckpt``/``.pt``/``.pth`` (the UNet is read;
the unlearning CLIs' ``final.pt`` is one); without it the seeded UNet.
The VAE and the text encoder are the seeded ones of ``sd_common``. A
case's x_T comes from a generator on the device seeded with its
``evaluation_seed`` (42 where the column is absent; an empty cell raises).
``--device`` empty or ``cuda[:N]`` is the card, ``cpu`` the CPU. Case i's
PNGs are encoded on the host while the card samples case i + 1. The CSV
is read with the standard ``csv`` module as pandas reads it for the JAX
CLI and the reference (a prompt cell pandas takes for NaN is "nan").
"""
from __future__ import annotations

import argparse
import csv
import logging
import os

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--prompts_path", type=str, required=True)
    p.add_argument("--save_path", type=str, required=True)
    p.add_argument("--ckpt_path", type=str, default="")
    p.add_argument("--model_name", type=str, default="",
                   help="accepted for reference parity; weights come from "
                        "--ckpt_path")
    p.add_argument("--device", type=str, default="",
                   help="empty or cuda[:N] (the card; fails without one) "
                        "or cpu")
    p.add_argument("--sampler", type=str, default="ddim",
                   choices=["ddim", "plms", "lms"],
                   help="lms = the diffusers LMSDiscreteScheduler protocol "
                        "the reference evaluator runs "
                        "(SD/eval-scripts/generate-images.py)")
    p.add_argument("--num_samples", type=int, default=1)
    p.add_argument("--ddim_steps", type=int, default=50)
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--from_case", type=int, default=0)
    return p.parse_args(argv)


# the cells pandas.read_csv reads as NaN by default; ``str(row.prompt)``
# of such a cell is "nan", the prompt the JAX CLI and the reference sample
# (the I2P CSV's row 2260 has an empty prompt)
_PANDAS_NA = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"))


def _int(cell: str) -> int:
    """A numeric CSV cell as pandas' ``int(row.col)`` reads it: "7" and
    "7.0" give 7; an empty cell raises ValueError, as ``int(nan)`` does."""
    if cell is None or not cell.strip():
        raise ValueError("an empty cell where an integer is needed")
    try:
        return int(cell)
    except ValueError:
        return int(float(cell))


def read_prompts(path: str, from_case: int = 0) -> list[tuple[int, str, int]]:
    """(case_number, prompt, evaluation_seed) of each row from
    ``from_case`` on, in file order, as the JAX CLI reads them with
    pandas."""
    with open(path, newline="", encoding="utf-8-sig") as f:
        rows = list(csv.DictReader(f))
    out = []
    for row in rows:
        case = _int(row["case_number"])
        if case < from_case:
            continue
        seed = (_int(row["evaluation_seed"]) if "evaluation_seed" in row
                else 42)
        prompt = row["prompt"]
        out.append((case, "nan" if prompt in _PANDAS_NA else prompt, seed))
    return out


def to_uint8(images: np.ndarray) -> np.ndarray:
    """Decoded float32 images about [-1, 1] -> uint8, truncated (not
    rounded), as the JAX CLI writes them."""
    return (np.clip((images + 1) / 2, 0, 1) * 255).astype(np.uint8)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from PIL import Image

    from uurg_torch.cli.sd_common import setup_workload

    wl, unet = setup_workload(args, args.device or None)
    dev = wl.device
    latent = args.image_size // 8
    sample = wl.make_sampler(num_steps=args.ddim_steps,
                             guidance_scale=args.guidance_scale,
                             latent_size=latent, method=args.sampler)
    cases = read_prompts(args.prompts_path, args.from_case)
    os.makedirs(args.save_path, exist_ok=True)

    def flush(pending):
        case, host, done = pending
        if done is not None:
            done.synchronize()
        imgs = to_uint8(host.numpy())
        for i in range(args.num_samples):
            Image.fromarray(imgs[i]).save(
                os.path.join(args.save_path, f"{case}_{i}.png"))
        logging.info("case %d done", case)

    pending = None  # PNG-encode case i while the card samples case i + 1
    for case, prompt, seed in cases:
        ctx = wl.get_learned_conditioning([prompt]).repeat(
            args.num_samples, 1, 1)
        z = sample(unet, ctx,
                   generator=torch.Generator(device=dev).manual_seed(seed))
        with torch.inference_mode():
            imgs = wl.vae.decode(z)
        if dev.type == "cuda":
            host = torch.empty(imgs.shape, dtype=imgs.dtype, pin_memory=True)
            host.copy_(imgs, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(dev))
        else:
            host, done = imgs, None
        if pending is not None:
            flush(pending)
        pending = (case, host, done)
    if pending is not None:
        flush(pending)


if __name__ == "__main__":
    main()
