"""DiT class-forgetting CLI, the flags of ``cli/forget.py``
(DiT/forget.py:364-397) plus ``--device``: SFR-on on DiT-XL/2 ImageNet-256
latents, pre-encoded (npz shards, ``encode_latents``) or encoded batch by
batch from an image folder by the frozen VAE (``--vae_ckpt``).

    python -m uurg_torch.cli.forget --data-path SHARDS --mask-path \\
        MASKS/0/fisher_1.0 --pack_mask --unlearn-loss adaga

Writes ``<results-dir>/forget_<class>/``: ``ckpt_{i:07d}.pt`` and
``train_state.pt`` every ``--ckpt-every`` steps, ``final.pt`` at the end
(reference DiT layout, ``{"model", "ema"}``), and a CFG latent sample grid
``vis_step{i:06d}.npz`` every ``--snapshot-every`` steps (latents, not
decoded, as in the JAX CLI). A run resumes from its
``train_state.pt``. ``--mesh data=N`` (or ``data=N,model=M``,
``stage=S``, ``data=N,seq=S``) and ``--parallelism dp|fsdp|tp|pp|sp`` run
on every rank of a ``torchrun`` group (one card a rank; ``--device cpu``
runs the ranks on gloo); ``tp`` shards the blocks' projections over
``model`` (``DIT_TP_RULES``), ``pp`` pipelines the blocks over ``stage`` in
``--pp_microbatches`` (0: the stage count), ``sp`` runs the attention as a
ring over ``seq``:

    torchrun --nproc_per_node 2 -m uurg_torch.cli.forget --mesh data=2 \
        --parallelism fsdp ...
    torchrun --nproc_per_node 2 -m uurg_torch.cli.forget --mesh model=2 \
        --parallelism tp ...
    torchrun --nproc_per_node 2 -m uurg_torch.cli.forget --mesh stage=2 \
        --parallelism pp --pp_microbatches 4 ...

Rank 0 writes the files.
"""
from __future__ import annotations

import argparse
import logging
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--data-path", type=str, default="")
    p.add_argument("--results-dir", type=str, default="results/dit")
    p.add_argument("--model", type=str, default="DiT-XL/2")
    p.add_argument("--image-size", type=int, default=256,
                   choices=[256, 512])
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--label-to-forget", "--forget-class", type=int,
                   default=0)
    p.add_argument("--ckpt", type=str, default="",
                   help="pretrained DiT checkpoint (reference .pt)")
    p.add_argument("--n-iters", type=int, default=600)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--forget-alpha", type=float, default=1e-3)
    p.add_argument("--remain-alpha", type=float, default=1.0)
    p.add_argument("--unlearn-loss", type=str, default="ga",
                   choices=["ga", "adaga", "rl"])
    p.add_argument("--decay-forget-alpha", action="store_true")
    p.add_argument("--grad-clip", type=float, default=1.0)
    p.add_argument("--method", type=str, default="ron",
                   choices=["ron", "joint"])
    p.add_argument("--snapshot-every", type=int, default=500,
                   help="CFG sample-grid frequency during forgetting")
    p.add_argument("--vae", type=str, default="ema",
                   help="accepted for reference parity")
    p.add_argument("--num-workers", type=int, default=0,
                   help="accepted for reference parity (host pipeline)")
    p.add_argument("--mask-path", type=str, default="")
    p.add_argument("--vae_ckpt", type=str, default="",
                   help="the frozen VAE that encodes an image folder: a "
                        "CompVis first-stage .ckpt/.pth or the port's own "
                        ".pt; a seeded init when empty")
    p.add_argument("--global-batch-size", "--batch-size", type=int,
                   default=32)
    p.add_argument("--global-seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--ckpt-every", type=int, default=10000)
    p.add_argument("--mesh", type=str, default="",
                   help="mesh over the ranks, e.g. data=2 or "
                        "data=2,model=2 (-1 fills the rest)")
    p.add_argument("--parallelism", type=str, default="dp",
                   choices=["dp", "fsdp", "tp", "pp", "sp"],
                   help="dp, fsdp or tp over the mesh; pp: the blocks "
                        "pipelined over a 'stage' axis; sp: ring attention "
                        "over a 'seq' axis")
    p.add_argument("--pp_microbatches", type=int, default=0,
                   help="pipeline microbatches (pp only); 0 = stage count")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="gradient-accumulation microbatches per update")
    p.add_argument("--remat_policy", type=str, default="full",
                   choices=["full", "attn", "dots", "attn+dots"],
                   help="backward recompute: full = every block; attn = "
                        "keep the attention outputs; dots = keep the "
                        "matmul outputs")
    p.add_argument("--mu_dtype", type=str, default="f32",
                   choices=["f32", "bf16"],
                   help="Adam first-moment storage dtype")
    p.add_argument("--nu_dtype", type=str, default="f32",
                   choices=["f32", "bf16"],
                   help="Adam second-moment storage dtype")
    p.add_argument("--pack_mask", action="store_true",
                   help="bit-pack the saliency mask (8x less memory)")
    p.add_argument("--profile_dir", type=str, default="",
                   help="write a torch.profiler trace of the run there "
                        "(trace.json, Chrome/Perfetto); empty = off")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a GPU) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    import torch

    from uurg_torch.cli.dit_common import (build_workload,
                                           forget_remain_iterators)
    from uurg_torch.core.device import refuse_multi_device
    from uurg_torch.parallel import (initialize_distributed, make_mesh,
                                     parse_mesh_spec)
    from uurg_torch.utils.profiling import maybe_trace
    from uurg_torch.workloads import ddpm_runner
    from uurg_torch.workloads.dit_runner import dit_forget, dit_sample_grid

    refuse_multi_device(args.parallelism)
    initialize_distributed(device=args.device)
    mesh = make_mesh(parse_mesh_spec(args.mesh)) if args.mesh else None
    wl, model = build_workload(args, args.device)
    mask = (ddpm_runner.load_mask(args.mask_path, model)
            if args.mask_path else None)
    forget_it, remain_it = forget_remain_iterators(args, args.device)
    ckpt_dir = os.path.join(args.results_dir,
                            f"forget_{args.label_to_forget}")
    os.makedirs(ckpt_dir, exist_ok=True)

    def sample_hook(state, step_idx):
        """The CFG latent sample grid of a snapshot (DiT/forget.py:344-345
        sample_visualization), from the EMA model."""
        dit_sample_grid(wl, state.ema_model,
                        os.path.join(ckpt_dir, f"vis_step{step_idx:06d}.npz"),
                        n_per_class=2,
                        classes=list(range(min(8, args.num_classes))),
                        seed=args.global_seed)

    bf16 = {"f32": None, "bf16": torch.bfloat16}
    with maybe_trace(args.profile_dir):
        dit_forget(
            wl, model, forget_it, remain_it,
            n_iters=args.n_iters, lr=args.lr,
            forget_alpha=args.forget_alpha,
            remain_alpha=args.remain_alpha, unlearn_loss=args.unlearn_loss,
            method=args.method, label_to_forget=args.label_to_forget,
            mask=mask, seed=args.global_seed, log_freq=args.log_every,
            decay_forget_alpha=args.decay_forget_alpha,
            grad_clip=args.grad_clip,
            ckpt_dir=ckpt_dir, ckpt_freq=args.ckpt_every,
            sample_hook=sample_hook, snapshot_freq=args.snapshot_every,
            mesh=mesh, parallelism=args.parallelism,
            pp_microbatches=args.pp_microbatches or None,
            grad_accum=args.grad_accum,
            mu_dtype=bf16[args.mu_dtype], nu_dtype=bf16[args.nu_dtype],
            pack_mask=args.pack_mask)
    print(f"done: {ckpt_dir}")


if __name__ == "__main__":
    main()
