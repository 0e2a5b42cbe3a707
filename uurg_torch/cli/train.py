"""DDPM train/unlearn CLI, the flags of ``cli/train.py`` (DDPM/train.py:15-172).

Run as ``python -m uurg_torch.cli.train --config configs/cifar10_sfron.yml
--mode sfron --ckpt_folder RUN_DIR --label_to_forget 0``. The config and
the run directory's ``logs/config.yaml`` go through the port's own YAML
reader and writer (no PyYAML); the snapshot grids need Pillow.

Modes: pretrain | retrain | sfron | sa | salun | generate_fisher |
generate_mask. ``sa`` (Selective Amnesia) reads ``<ckpt_folder>/fisher_dict``
from ``python -m uurg_torch.cli.fim`` and the remember images of
``<ckpt_folder>/class_samples`` (the remain split when there is none).
``generate_fisher`` writes ``<ckpt_folder or run dir>/mask_<label>/
{forget_fisher, remain_fisher, fisher_<th>}`` (one mask a ``--threshold``),
``generate_mask`` the SalUn masks ``.../salun_mask_<label>/with_<ratio>``
(one a ``--mask_ratio``); ``sfron`` and ``salun`` read such a mask file from
``--mask_path`` (``salun`` forces ``--unlearn_loss rl``).
"""
from __future__ import annotations

import argparse
import logging
import os

# flags accepted for parity that no mode reads, with their defaults; any
# other value raises rather than being ignored
_UNREAD = {"skip_type": "uniform", "eta": 0.0, "uc": True,
           "negative_guidance": 1.0, "sparse": False}


def str2bool(v) -> bool:
    # argparse type=bool takes any non-empty string (incl. "False") as True
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(f"boolean value expected, got {v!r}")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--mode", type=str, default="pretrain",
                   choices=["pretrain", "retrain", "sfron", "sa", "salun",
                            "generate_mask", "generate_fisher"])
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--exp", type=str, default="results")
    p.add_argument("--ckpt_folder", type=str, default="")
    p.add_argument("--label_to_forget", type=int, default=0)
    p.add_argument("--cond_scale", type=float, default=2.0)
    # sfron flags (DDPM/train.py)
    p.add_argument("--forget_alpha", type=float, default=10.0)
    p.add_argument("--remain_alpha", type=float, default=1.0)
    p.add_argument("--decay_forget_alpha", action="store_true")
    p.add_argument("--method", type=str, default="ron",
                   choices=["ron", "joint"])
    p.add_argument("--unlearn_loss", type=str, default="adaga",
                   choices=["adaga", "ga", "rl"])
    p.add_argument("--mask_path", type=str, default="",
                   help="saliency mask file (sfron, salun), e.g. "
                        "<ckpt_folder>/mask_0/fisher_1.0")
    # sampling knobs of the snapshot grids (DDPM/train.py parity)
    p.add_argument("--sample_type", type=str, default="generalized",
                   choices=["generalized", "ddpm_noisy"],
                   help="generalized = DDIM, ddpm_noisy = ancestral")
    p.add_argument("--skip_type", type=str, default="uniform",
                   choices=["uniform", "quad"])
    p.add_argument("--timesteps", type=int, default=50,
                   help="sampling steps for snapshot grids")
    p.add_argument("--eta", type=float, default=0.0)
    p.add_argument("--verbose", type=str, default="info")
    # reference flags accepted for command-line parity; no mode reads them,
    # so a value other than the default raises (_UNREAD)
    p.add_argument("--uc", type=str2bool, default=True)
    p.add_argument("--negative_guidance", type=float, default=1.0)
    p.add_argument("--sparse", type=str2bool, default=False)
    # mask generation
    p.add_argument("--threshold", type=float, nargs="+", default=[1.0],
                   help="generate_fisher: Fisher-ratio thresholds, one mask "
                        "each")
    p.add_argument("--mask_ratio", type=float, nargs="+", default=[0.5],
                   help="generate_mask: SalUn top-k ratios, one mask each")
    p.add_argument("--n_iters", type=int, default=0,
                   help="override config training.n_iters (smoke runs)")
    p.add_argument("--rng_impl", type=str, default="auto",
                   choices=["auto", "rbg", "threefry2x32"],
                   help="JAX PRNG choice; the port draws from torch "
                        "generators and takes only auto")
    p.add_argument("--profile_dir", type=str, default="",
                   help="write a torch.profiler trace of the run there "
                        "(trace.json, Chrome/Perfetto); empty = off")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a GPU) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    if args.rng_impl != "auto":
        raise NotImplementedError(
            "--rng_impl is JAX-only: the port draws from torch generators")
    unread = [f"--{k}" for k, default in _UNREAD.items()
              if getattr(args, k) != default]
    if unread:
        raise NotImplementedError(
            f"{', '.join(unread)}: accepted for command-line parity but read "
            f"by no mode; leave at the default")
    from uurg_torch.core.config import load_config
    from uurg_torch.core.expdir import setup_run_dirs
    from uurg_torch.parallel import initialize_distributed, rank
    from uurg_torch.workloads import ddpm_runner as R

    initialize_distributed(device=args.device)

    config = load_config(args.config)
    if args.n_iters > 0:
        config.training.n_iters = args.n_iters
    run_dir = setup_run_dirs(args, config, exp_root=args.exp)
    ckpt_dir = config.ckpt_dir

    def sample_hook(state, step_idx):
        """Snapshot grid (diffusion.py:874-928 sample_visualization): one
        row per class from the EMA model (the model itself without EMA),
        written under logs/. A failed grid is logged and the run goes on,
        as in the JAX package's CLI: it loses one picture, never the run."""
        try:
            _sample_grid(state, step_idx)
        except Exception:  # noqa: BLE001 - cosmetic path, log and continue
            logging.getLogger("uurg_torch.train").warning(
                "snapshot grid at step %d failed (continuing)", step_idx,
                exc_info=True)

    def _sample_grid(state, step_idx):
        import numpy as np

        from uurg_torch.utils.images import save_grid

        n_classes = config.data.n_classes
        n_vis = min(config.training.get("visualization_samples", 100),
                    10 * n_classes)
        labels = np.tile(np.arange(n_classes), max(1, n_vis // n_classes))
        model = state.ema_model if state.ema_model is not None \
            else state.model
        imgs = R.sample_images(
            args, config, model, labels,
            num_steps=min(args.timesteps,
                          config.diffusion.num_diffusion_timesteps),
            method="ddpm" if args.sample_type == "ddpm_noisy" else "ddim",
            cond_scale=args.cond_scale, batch_size=len(labels),
            seed=args.seed)
        if rank() == 0:
            save_grid(imgs, os.path.join(config.log_dir,
                                         f"samples_step{step_idx:05d}.png"),
                      ncol=n_classes)

    hook = sample_hook if config.training.get("visualization_samples") \
        else None
    from uurg_torch.utils.profiling import maybe_trace

    with maybe_trace(args.profile_dir):
        if args.mode == "pretrain":
            R.pretrain(args, config, ckpt_dir, device=args.device)
        elif args.mode == "retrain":
            # exact unlearning: pretraining on the remain split only
            from uurg_torch.data.splits import class_forget_split

            remain, _ = class_forget_split(
                R._load_train_dataset(args, config), args.label_to_forget)
            R.pretrain(args, config, ckpt_dir, dataset=remain,
                       device=args.device)
        elif args.mode == "generate_fisher":
            out = os.path.join(args.ckpt_folder or run_dir,
                               f"mask_{args.label_to_forget}")
            R.generate_fisher(args, config, out, device=args.device)
            R.generate_fisher_mask(out, args.threshold, device=args.device)
        elif args.mode == "generate_mask":
            out = os.path.join(args.ckpt_folder or run_dir,
                               f"salun_mask_{args.label_to_forget}")
            R.generate_salun_mask(args, config, out, args.mask_ratio,
                                  device=args.device)
        elif args.mode == "sa":
            R.sa_forget(args, config, ckpt_dir, device=args.device)
        else:
            if args.mode == "salun":
                # SalUn = RandomLabel loss + top-k mask, through the same
                # engine
                args.unlearn_loss = "rl"
            R.sfron_forget(args, config, ckpt_dir, sample_hook=hook,
                           device=args.device)
    print(f"done: {run_dir}")


if __name__ == "__main__":
    main()
