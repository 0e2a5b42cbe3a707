"""SA-FIM CLI, the flags of ``cli/fim.py`` (DDPM/fim.py): the per-sample
full-ELBO Fisher information of Selective Amnesia, chunked over timesteps.

Run as ``python -m uurg_torch.cli.fim --config configs/cifar10_sa.yml
--ckpt_folder RUN_DIR``; writes ``<ckpt_folder>/fisher_dict``, which
``python -m uurg_torch.cli.train --mode sa --ckpt_folder RUN_DIR`` reads.
The config is read by the port's own YAML reader (no PyYAML).

The model is ``<ckpt_folder>/ckpts/ckpt.pth`` (a seeded fresh model when
there is none). The timesteps are cut into ``n_chunks`` chunks of ``T //
n_chunks`` (the remainder dropped). For each chunk, batches of the whole
training set, unshuffled, are taken until ``n_samples`` examples were seen
(checked before each batch, so the last batch may overshoot); each example
gives one forward over the chunk's timesteps and one backward, in eval
mode, and the batch adds the mean of its examples' squared gradients. The
sum over all batches is divided by ``n_chunks`` at the end, as the JAX CLI
does.
"""
from __future__ import annotations

import argparse
import logging
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--ckpt_folder", type=str, required=True)
    p.add_argument("--n_chunks", type=int, default=20)
    p.add_argument("--n_samples", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a GPU) or cpu")
    return p.parse_args(argv)


def generate_fim(args, config, device=None) -> str:
    """Compute the SA Fisher of the model ``load_params`` gives (see the
    module docstring) on ``device``, CUDA unless "cpu" is asked for, and
    write it to ``<args.ckpt_folder>/fisher_dict``; returns that path.
    Example ``e`` of batch ``b`` of chunk ``k`` draws its noise from a
    generator seeded by (seed, k, b, e) through ``step_seed``."""
    import torch

    from uurg_torch.core.rng import step_seed
    from uurg_torch.data.arrays import epoch_batches
    from uurg_torch.io.checkpoint import save_checkpoint
    from uurg_torch.unlearn import fisher as F
    from uurg_torch.workloads import ddpm_runner as R
    from uurg_torch.workloads.ddpm import DDPMWorkload

    log = logging.getLogger("uurg_torch.fim")
    wl = DDPMWorkload.from_config(config, device=device)
    model = R.load_params(args, config, wl)
    ds = R._load_train_dataset(args, config)
    chunk = wl.schedule.num_timesteps // args.n_chunks
    fisher = {n: torch.zeros_like(p, dtype=torch.float32)
              for n, p in model.named_parameters()}
    step = F.make_per_sample_fisher_step(wl.elbo_chunk_loss_fn())
    model.eval()
    for ci in range(args.n_chunks):
        ts = torch.arange(ci * chunk, (ci + 1) * chunk, device=wl.device)
        n_seen = 0
        for bi, (x, c) in enumerate(epoch_batches(ds, args.batch_size)):
            if n_seen >= args.n_samples:
                break
            x, c = R._device_batch(config, x, c, wl.device)
            step(fisher, model, (x, c, ts.expand(len(x), chunk)),
                 step_seed(step_seed(args.seed, ci), bi))
            n_seen += len(x)
        log.info("chunk %d/%d done (%d examples)", ci + 1, args.n_chunks,
                 n_seen)
    torch._foreach_mul_(list(fisher.values()), 1.0 / args.n_chunks)
    out = os.path.join(args.ckpt_folder, "fisher_dict")
    save_checkpoint(out, fisher)
    return out


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    from uurg_torch.core.config import load_config

    out = generate_fim(args, load_config(args.config), device=args.device)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
