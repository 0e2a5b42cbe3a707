"""Classification random-subset unlearning CLI, the flags of
``cli/main_random.py`` (Classification/main_random.py:23-157) plus
``--device``: split -> unlearn -> evaluate -> CSV.

Run as ``python -m uurg_torch.cli.main_random --unlearn_method SFRon``.
Without the dataset under ``--data_path`` it falls back to the synthetic
stand-in (2,048 train and 512 test images). ``--checkpoint`` is a file the
port wrote (``main_pretrain``'s ``<model>_best``, or a ``<method>_unlearned``
of this CLI); an Orbax directory of the JAX package raises (it needs JAX to
read). The unlearned model is written to ``<save_path>/<method>_unlearned``
and its row appended to ``<save_path>/results.csv``.
"""
from __future__ import annotations

import argparse
import csv
import logging
import os
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    # reference aliases (Classification/main_random.py flag names) are kept
    # so the published command lines run verbatim
    p.add_argument("--dataset", "-d", type=str, default="CIFAR10")
    p.add_argument("--data_path", "--data_dir", type=str, default="./data")
    p.add_argument("--model", type=str, default="ResNet18")
    p.add_argument("--num_classes", type=int, default=10)
    p.add_argument("--input_size", nargs=3, type=int, default=None,
                   help="accepted for reference parity; shapes derive from "
                        "the dataset here")
    p.add_argument("--record_result", action="store_true", default=True,
                   help="append the summary CSV (reference flag; default on)")
    p.add_argument("--unlearn_method", "--unlearn", type=str,
                   default="SFRon")
    p.add_argument("--forget_mode", type=str, default="random",
                   choices=["random", "class"],
                   help="random subset (RandomUnlearn) or full class "
                        "(FullClassUnlearn) split")
    p.add_argument("--label_to_forget", type=int, default=0)
    p.add_argument("--forget_ratio", "--forget_perc", type=float,
                   default=0.1)
    p.add_argument("--incremental", type=int, default=0,
                   help="N>0: incremental unlearning over N cumulative "
                        "stages (IncrementalRandomUnlearn parity)")
    p.add_argument("--svc_mia", action="store_true",
                   help="also run the SVC shadow-model MIA")
    p.add_argument("--compare", type=str, default="",
                   help="comma list of methods (e.g. Baseline,Retrain,SFRon)"
                        ": run the comparative protocol from ONE pretrained "
                        "model and append one CSV row per method")
    p.add_argument("--pretrain_epochs", type=int, default=30,
                   help="compare mode: pretrain budget when no --checkpoint "
                        "is given")
    p.add_argument("--checkpoint", type=str, default="",
                   help="pretrained model checkpoint (a file the port wrote)")
    p.add_argument("--retrain_checkpoint", type=str, default="",
                   help="retrained reference for the JS divergence")
    p.add_argument("--synthetic_affinity", type=float, default=0.0,
                   help="stand-in data only: blend each synthetic class "
                        "mean toward its ring-successor (see "
                        "data.datasets.synthetic_dataset)")
    p.add_argument("--pretrain_lr", type=float, default=0.1,
                   help="compare mode: pretrain/Retrain peak lr "
                        "(main_pretrain.py recipe default); lower it (~0.05) "
                        "on noisy stand-in data")
    p.add_argument("--synthetic_noise", type=float, default=0.1,
                   help="stand-in data only: per-sample noise sigma (~0.5 "
                        "opens a train/test confidence gap for the SVC-MIA)")
    p.add_argument("--batch_size", "-b", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save_path", type=str, default="results/classification")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "f32", "bfloat16", "bf16"],
                   help="convolution compute dtype; BatchNorm, the residual "
                        "sums and the fc stay float32. float32 (the default) "
                        "runs with TF32 off on CUDA")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a GPU) or cpu")
    return p.parse_args(argv)


def load_classification_data(args):
    """(train, test) from the dataset registry, or the synthetic stand-in
    (2,048 / 512 images sharing ``base_seed``) when the files are
    missing."""
    from uurg_torch.data.datasets import dataset_registry, synthetic_dataset

    try:
        loader = dataset_registry.get(args.dataset)
        return loader(args.data_path, True), loader(args.data_path, False)
    except FileNotFoundError:
        logging.warning("dataset %s not found; synthetic fallback",
                        args.dataset)
    kw = dict(base_seed=args.seed,
              class_affinity=getattr(args, "synthetic_affinity", 0.0),
              noise_sigma=getattr(args, "synthetic_noise", 0.1))
    return (synthetic_dataset(2048, 32, 3, args.num_classes, args.seed, **kw),
            synthetic_dataset(512, 32, 3, args.num_classes, args.seed + 1,
                              **kw))


def build_classifier(args, device):
    """The model of ``--model`` at ``--dtype``, initialised from ``--seed``
    (flax's scheme) on the CPU and moved to ``device``, and its
    ``init_fn(seed)`` for Retrain and BadTeacher."""
    import torch

    from uurg_torch.models import create_model, init_classifier

    dtype = (torch.bfloat16 if args.dtype in ("bfloat16", "bf16")
             else torch.float32)

    def init_fn(seed: int) -> torch.nn.Module:
        model = create_model(args.model, args.num_classes, dtype=dtype)
        return init_classifier(torch.Generator().manual_seed(seed),
                               model).to(device)

    return init_fn(args.seed), init_fn


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from uurg_torch.core.device import resolve_device
    from uurg_torch.data.arrays import (epoch_batches, pad_crop_batch,
                                        random_flip_batch)
    from uurg_torch.data.splits import (class_forget_split,
                                        incremental_random_split,
                                        random_forget_split)
    from uurg_torch.eval.features import softmax
    from uurg_torch.eval.js_div import get_js_divergence
    from uurg_torch.eval.mia import membership_attack_prob, svc_mia
    from uurg_torch.io.checkpoint import restore_checkpoint, save_checkpoint
    from uurg_torch.unlearn.methods.classification import (
        UnlearnContext, unlearn_method_registry)
    from uurg_torch.workloads.classification import Classifier

    device = resolve_device(args.device)
    os.makedirs(args.save_path, exist_ok=True)
    train_ds, test_ds = load_classification_data(args)
    if args.forget_mode == "class":
        retain, forget = class_forget_split(train_ds, args.label_to_forget)
    else:
        retain, forget = random_forget_split(train_ds, args.forget_ratio,
                                             args.seed, args.save_path)

    model, init_fn = build_classifier(args, device)
    if args.checkpoint:
        model.load_state_dict(restore_checkpoint(args.checkpoint, like=model))
    cls = Classifier(device)

    def aug(x, rng):
        return random_flip_batch(pad_crop_batch(x, 4, rng), rng)

    if args.compare:
        from uurg_torch.unlearn.protocol import run_comparison

        rows = run_comparison(
            model, train_ds, test_ds,
            methods=[m for m in args.compare.split(",") if m],
            forget_mode=args.forget_mode,
            label_to_forget=args.label_to_forget,
            forget_ratio=args.forget_ratio,
            batch_size=args.batch_size, seed=args.seed,
            num_classes=args.num_classes,
            pretrain_epochs=args.pretrain_epochs,
            pretrain_lr=args.pretrain_lr,
            # Retrain trains from scratch with the pretrain stage's recipe
            overrides={"Retrain": {"lr": args.pretrain_lr}},
            pretrained=bool(args.checkpoint), transform=aug,
            csv_path=os.path.join(args.save_path, "results.csv"),
            save_path=args.save_path)
        for row in rows:
            print(row)
        return

    method = unlearn_method_registry.get(args.unlearn_method)
    t0 = time.time()
    if args.incremental > 0:
        # IncrementalRandomUnlearn: cumulative forget stages, each unlearning
        # from the previous stage's model
        stages = incremental_random_split(
            train_ds, args.forget_ratio, args.incremental, args.seed,
            args.save_path)
        unlearned = model
        for si, (retain, forget) in enumerate(stages):
            unlearned = method(UnlearnContext(
                classifier=cls, model=unlearned, retain_train=retain,
                forget_train=forget, num_classes=args.num_classes,
                batch_size=args.batch_size, seed=args.seed + si,
                save_path=args.save_path, transform=aug, init_fn=init_fn))
            logging.info("incremental stage %d/%d done", si + 1,
                         args.incremental)
    else:
        unlearned = method(UnlearnContext(
            classifier=cls, model=model, retain_train=retain,
            forget_train=forget, num_classes=args.num_classes,
            batch_size=args.batch_size, seed=args.seed,
            save_path=args.save_path, transform=aug, init_fn=init_fn))
    unlearn_time = time.time() - t0

    def batches(ds):
        return epoch_batches(ds, args.batch_size)

    res = {
        "method": args.unlearn_method,
        "unlearn_time": round(unlearn_time, 2),
        "retain_acc": cls.validate(unlearned, batches(retain))["acc"],
        "forget_acc": cls.validate(unlearned, batches(forget))["acc"],
        "test_acc": cls.validate(unlearned, batches(test_ds))["acc"],
    }
    rp, rl = cls.collect_logits(unlearned, batches(retain))
    fp, fl = cls.collect_logits(unlearned, batches(forget))
    tp, tl = cls.collect_logits(unlearned, batches(test_ds))
    res["mia"] = membership_attack_prob(
        softmax(rp), rl, softmax(fp), fl, softmax(tp), tl)

    if args.svc_mia:
        n = min(len(rl), len(tl))
        svc = svc_mia((softmax(rp[:n]), rl[:n]), (softmax(tp[:n]), tl[:n]),
                      (softmax(fp), fl), (np.zeros((0, rp.shape[1])),
                                          np.zeros((0,), np.int64)))
        for k, v in svc.items():
            res[f"svc_{k}"] = v

    if args.retrain_checkpoint:
        retrained, _ = build_classifier(args, device)
        retrained.load_state_dict(restore_checkpoint(args.retrain_checkpoint,
                                                     like=retrained))
        rpp, _ = cls.collect_logits(retrained, batches(forget))
        res["js_div"] = get_js_divergence(softmax(fp), softmax(rpp))

    save_checkpoint(os.path.join(args.save_path,
                                 f"{args.unlearn_method}_unlearned"),
                    unlearned.state_dict())

    csv_path = os.path.join(args.save_path, "results.csv")
    write_header = not os.path.exists(csv_path)
    with open(csv_path, "a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(res))
        if write_header:
            w.writeheader()
        w.writerow(res)
    print(res)
    return res


if __name__ == "__main__":
    main()
