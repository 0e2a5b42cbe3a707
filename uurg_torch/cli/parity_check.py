"""Parity kit: locally dropped reference artifacts -> the whole north-star
run -> metric-band report against BASELINE.md.

The port's twin of ``cli/parity_check.py``. Run as ``python -m
uurg_torch.cli.parity_check [--quick] [--device cpu]``. It scans
``--artifacts`` for:

  cifar-10-batches-py/          CIFAR-10 python batches
  ckpts/ckpt.pth | ckpt.pth     reference pretrained conditional DDPM
                                (read through ddpm_runner.load_params from
                                <artifacts>/ckpts/ckpt.pth)
  pt_inception-2015-12-05.pth   FID InceptionV3 (pytorch-fid's torch port)
  resnet34_classifier.pth       fine-tuned torchvision ResNet-34 UA probe
                                (DDPM/classifier_evaluation.py:16-40)

and runs the whole protocol (DDPM/README.md:44-63,139-168): Fisher ->
saliency mask -> SFR-on -> sampling of the remaining classes and of the
forgotten class -> IS/FID/sFID/precision/recall and the UA probe's entropy
and probability, checked against the bands below (targets from
BASELINE.md:9-15). A missing artifact is replaced by a stand-in (the
synthetic CIFAR-10, a seeded random init) so every stage still runs, and
the band checks are then reported SKIPPED.

Bands (20%% relative slack on the reference's single published run):
  fid <= 11.60   is >= 7.38   sfid <= 8.93   precision >= 0.31
  recall >= 0.63   entropy >= 1.17   prob_forgotten <= 0.19

Writes <out>/fisher/, <out>/unlearned/ckpt.pth, <out>/samples.npz,
<out>/probe_samples.npz and <out>/parity_report.json, and prints the table.
Exit code: 1 iff a band check FAILS; SKIPPED never fails the run. Runs on
the card (``--device cuda``, the default, raises without one) or on the
CPU with ``--device cpu``; the config YAML is read without PyYAML.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import types

import numpy as np

log = logging.getLogger("uurg_torch.parity")

BANDS = {
    "fid": ("<=", 9.6705 * 1.2),
    "inception_score": (">=", 8.1986 * 0.9),
    "sfid": ("<=", 7.4390 * 1.2),
    "precision": (">=", 0.3908 * 0.8),
    "recall": (">=", 0.7879 * 0.8),
    "avg_entropy": (">=", 1.4655 * 0.8),
    "avg_prob_forgotten": ("<=", 0.1563 * 1.2),
}
# the --quick overrides of the JAX kit: pipeline validation at a tiny scale
QUICK_CONFIG = {
    "model": {"ch": 32, "ch_mult": [1, 2], "attn_resolutions": []},
    "training": {"n_iters": 10, "snapshot_freq": 10, "batch_size": 32},
    "sampling": {"batch_size": 64},
    "data": {"synthetic_n": 512},
}
QUICK_SAMPLES, QUICK_PROBE, QUICK_STEPS, QUICK_REFS = 90, 32, 10, 96


def find_artifacts(root: str) -> dict:
    """Map artifact name -> path-or-None."""
    def first(*cands):
        for c in cands:
            p = os.path.join(root, c)
            if os.path.exists(p):
                return p
        return None

    return {
        "cifar10": first("cifar-10-batches-py"),
        "ddpm_ckpt": first("ckpts/ckpt.pth", "ckpt.pth"),
        "inception": first("pt_inception-2015-12-05.pth"),
        "probe": first("resnet34_classifier.pth"),
    }


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--artifacts", type=str, default="./artifacts")
    p.add_argument("--out", type=str, default="results/parity")
    p.add_argument("--config", type=str, default="configs/cifar10_sfron.yml")
    p.add_argument("--label_to_forget", type=int, default=0)
    p.add_argument("--forget_alpha", type=float, default=1e-4,
                   help="reference default for the DDPM recipe "
                        "(DDPM/README.md:56)")
    p.add_argument("--mask_threshold", type=float, default=1.0)
    p.add_argument("--n_samples", type=int, default=45000,
                   help="remaining-classes sample count (reference: 5000 "
                        "per remaining class)")
    p.add_argument("--n_probe", type=int, default=5000,
                   help="forgotten-class samples for the UA probe")
    p.add_argument("--sample_steps", type=int, default=50)
    p.add_argument("--quick", action="store_true",
                   help="tiny stand-in scale: small model, few iters, few "
                        "hundred samples — pipeline validation only")
    p.add_argument("--skip_fisher", action="store_true",
                   help="unlearn without the saliency mask stage")
    p.add_argument("--pack_mask", action="store_true",
                   help="bit-pack the saliency mask (1 bit/elem)")
    p.add_argument("--nu_dtype", type=str, default="f32",
                   choices=["f32", "bf16"],
                   help="Adam second-moment storage dtype of the SFR-on "
                        "stage (bf16 halves its memory)")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize UNet res blocks in the backward "
                        "(model.remat)")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a GPU) or cpu")
    return p.parse_args(argv)


def _uint8(images: np.ndarray) -> np.ndarray:
    """Dataset images (uint8, or float32 in [0, 1] for the stand-in) ->
    uint8, the scale InceptionV3's preprocessing expects."""
    if images.dtype == np.uint8:
        return images
    return (np.clip(images, 0.0, 1.0) * 255.0).round().astype(np.uint8)


def run(args, config, device=None) -> dict:
    """The five stages on ``config`` (a reference-schema Config; the quick
    overrides and ``data.path`` are applied to a copy) and ``device`` (CUDA
    unless "cpu" is asked for). Writes the outputs under ``args.out`` and
    returns the report written to ``parity_report.json``."""
    import torch

    from uurg_torch.core.device import resolve_device
    from uurg_torch.core.rng import seeded_init_
    from uurg_torch.data.splits import class_forget_split
    from uurg_torch.eval.classifier_eval import classifier_probe
    from uurg_torch.eval.generative import evaluate_all
    from uurg_torch.eval.inception import load_inception, make_extractor
    from uurg_torch.io.tv_resnet_interop import load_torch_resnet_checkpoint
    from uurg_torch.models.resnet import ResNet34
    from uurg_torch.workloads import ddpm_runner

    device = resolve_device(device)
    os.makedirs(args.out, exist_ok=True)
    art = find_artifacts(args.artifacts)
    real = all(art.values())
    for name, path in art.items():
        log.info("artifact %-10s %s", name, path or "MISSING (stand-in)")
    if not real:
        log.warning("missing artifacts -> synthetic stand-ins; band checks "
                    "will be SKIPPED")

    # CIFAR-10 lives next to the checkpoints
    config = config.merged({"data": {"path": args.artifacts}})
    n_samples, n_probe, steps = args.n_samples, args.n_probe, \
        args.sample_steps
    if args.quick:
        config = config.merged(QUICK_CONFIG)
        n_samples, n_probe, steps = QUICK_SAMPLES, QUICK_PROBE, QUICK_STEPS
    if args.remat:
        config = config.merged({"model": {"remat": True}})
    run_args = types.SimpleNamespace(
        ckpt_folder=args.artifacts if art["ddpm_ckpt"] else "",
        label_to_forget=args.label_to_forget,
        forget_alpha=args.forget_alpha, remain_alpha=1.0,
        decay_forget_alpha=False, method="ron", unlearn_loss="adaga",
        mask_path="", seed=args.seed, pack_mask=args.pack_mask,
        nu_dtype=torch.bfloat16 if args.nu_dtype == "bf16" else None)

    # 1-2) Fisher diagonals and the saliency mask (DDPM/README.md:49-53)
    if not args.skip_fisher:
        fisher_dir = os.path.join(args.out, "fisher")
        marker = os.path.join(fisher_dir, f"fisher_{args.mask_threshold}")
        if not os.path.exists(marker):
            ddpm_runner.generate_fisher(run_args, config, fisher_dir,
                                        device=device)
            ddpm_runner.generate_fisher_mask(
                fisher_dir, [args.mask_threshold], device=device)
        run_args.mask_path = marker

    # 3) SFR-on unlearning (DDPM/README.md:54-58)
    state = ddpm_runner.sfron_forget(
        run_args, config, os.path.join(args.out, "unlearned"), device=device)
    model = state.ema_model if state.ema_model is not None else state.model
    del state

    # 4) sampling: remaining classes for FID, the forgotten class for UA
    classes = [c for c in range(config.data.n_classes)
               if c != args.label_to_forget]
    labels = np.repeat(classes, n_samples // len(classes)).astype(np.int64)
    log.info("sampling %d remaining-class images (%d steps)...",
             len(labels), steps)
    samples = ddpm_runner.sample_images(run_args, config, model, labels,
                                        num_steps=steps, seed=args.seed)
    log.info("sampling %d forgotten-class probe images...", n_probe)
    probe_samples = ddpm_runner.sample_images(
        run_args, config, model,
        np.full(n_probe, args.label_to_forget, np.int64), num_steps=steps,
        seed=args.seed + 1)
    del model
    np.savez_compressed(os.path.join(args.out, "samples.npz"),
                        arr_0=samples)
    np.savez_compressed(os.path.join(args.out, "probe_samples.npz"),
                        arr_0=probe_samples)

    # 5a) the ADM evaluator against the training set without the forgotten
    #     class (DDPM/README.md:139-143)
    remain, _ = class_forget_split(
        ddpm_runner._load_train_dataset(run_args, config),
        args.label_to_forget)
    inception = load_inception(art["inception"] or "")
    extractor = make_extractor(inception.to(device), materialize=False)
    # quick: few references (the 299 px InceptionV3 pass is the CPU's
    # bottleneck); the stand-in's float images become uint8 like samples
    refs = _uint8(remain.images[:QUICK_REFS] if args.quick
                  else remain.images)
    metrics = evaluate_all(extractor, refs, samples)
    del inception, extractor
    log.info("generative metrics: %s", metrics)

    # 5b) the UA probe on forgotten-class samples
    #     (DDPM/classifier_evaluation.py:16-40, README.md:167-168)
    probe = ResNet34(num_classes=config.data.n_classes, imagenet_stem=True)
    if art["probe"]:
        probe.load_state_dict(load_torch_resnet_checkpoint(art["probe"]),
                              strict=True)
    else:
        seeded_init_(probe, 1)
    probe = probe.to(device).eval()
    metrics.update(classifier_probe(
        probe, probe_samples, args.label_to_forget,
        resize_to=None if args.quick else 224, device=device))
    log.info("classifier probe: %s", metrics)

    # 6) band report
    report = []
    for name, (op, bound) in BANDS.items():
        value = metrics.get(name)
        if value is None:
            continue
        if not real:
            status = "SKIPPED (stand-in artifacts)"
        else:
            ok = value <= bound if op == "<=" else value >= bound
            status = "PASS" if ok else "FAIL"
        report.append({"metric": name, "value": round(float(value), 4),
                       "band": f"{op} {bound:.4f}", "status": status})
    out = {"artifacts": art, "real_run": real, "report": report,
           "metrics": metrics}
    with open(os.path.join(args.out, "parity_report.json"), "w") as f:
        json.dump(out, f, indent=2)
    return out


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from uurg_torch.core.config import load_config

    report = run(args, load_config(args.config), args.device)["report"]
    print(f"{'metric':<22}{'value':>10}  {'band':<12}status")
    for r in report:
        print(f"{r['metric']:<22}{r['value']:>10}  {r['band']:<12}"
              f"{r['status']}")
    sys.exit(1 if any(r["status"] == "FAIL" for r in report) else 0)


if __name__ == "__main__":
    main()
