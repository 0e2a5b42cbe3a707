"""Classifier pretraining CLI, the flags of ``cli/main_pretrain.py``
(Classification/main_pretrain.py:16-97) plus ``--device``: SGD or AdamW
with the per-epoch cosine schedule, the best test accuracy's weights kept.

Run as ``python -m uurg_torch.cli.main_pretrain --epochs 200``. Without the
dataset under ``--data_path`` it falls back to the synthetic stand-in
(2,048 train and 512 test images). After every epoch that improves the test
accuracy the model's ``state_dict()`` (parameters and BatchNorm buffers) is
written to ``<save_path>/<model>_best`` (``io/checkpoint.py``; ``main_random
--checkpoint`` reads it) and its accuracy and epoch to
``<save_path>/<model>_best.json``.
"""
from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    # reference flag names (Classification/main_pretrain.py) kept as aliases
    p.add_argument("--dataset", "-d", type=str, default="CIFAR10")
    p.add_argument("--data_path", "--data_dir", type=str, default="./data")
    p.add_argument("--model", type=str, default="ResNet18")
    p.add_argument("--num_classes", type=int, default=10)
    p.add_argument("--input_size", nargs=3, type=int, default=None,
                   help="accepted for reference parity")
    p.add_argument("--sched", type=str, default="cosine",
                   help="lr schedule (cosine, the reference default)")
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--batch_size", "-b", type=int, default=256)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--opt", type=str, default="sgd", choices=["sgd", "adamw"])
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight_decay", type=float, default=5e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save_path", type=str, default="results/pretrain")
    p.add_argument("--torch_init", type=str, default=None,
                   help="locally supplied torchvision/reference .pth to "
                        "initialise the backbone from (the reference's "
                        "weights='DEFAULT'; tensors whose shape differs, the "
                        "head, stay freshly initialised)")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "f32", "bfloat16", "bf16"],
                   help="convolution compute dtype; BatchNorm and the fc "
                        "stay float32. float32 runs with TF32 off on CUDA")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a GPU) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from uurg_torch.cli.main_random import (build_classifier,
                                            load_classification_data)
    from uurg_torch.core.device import resolve_device
    from uurg_torch.data.arrays import (epoch_batches, infinite_batches,
                                        pad_crop_batch, random_flip_batch)
    from uurg_torch.io.checkpoint import save_checkpoint
    from uurg_torch.train.optim import make_optimizer, set_lr
    from uurg_torch.workloads.classification import Classifier

    device = resolve_device(args.device)
    train_ds, test_ds = load_classification_data(args)
    model, _ = build_classifier(args, device)
    if args.torch_init:
        from uurg_torch.io.torch_classifier import (load_torch_classifier,
                                                    overlay_pretrained)
        overlay_pretrained(model, load_torch_classifier(args.torch_init,
                                                        args.model))
    cls = Classifier(device)
    opt = make_optimizer(args.opt, model.parameters(), args.lr,
                         momentum=args.momentum,
                         weight_decay=args.weight_decay)
    train_step = cls.make_train_step(opt)

    def aug(x, rng):
        return random_flip_batch(pad_crop_batch(x, 4, rng), rng)

    # floor, as the JAX CLI: the remainder of an epoch is dropped
    steps_per_epoch = max(1, len(train_ds) // args.batch_size)
    best_acc = -1.0
    os.makedirs(args.save_path, exist_ok=True)
    best_path = os.path.join(args.save_path, f"{args.model}_best")
    it_count = 0
    for epoch in range(args.epochs):
        set_lr(opt, args.lr * (1 + np.cos(np.pi * epoch / args.epochs)) / 2)
        it = infinite_batches(train_ds, args.batch_size,
                              seed=args.seed + epoch, transform=aug)
        for _ in range(steps_per_epoch):
            train_step(model, cls.batch(*next(it)), it_count)
            it_count += 1
        val = cls.validate(model, epoch_batches(test_ds, args.batch_size))
        logging.info("epoch %d val acc %.2f", epoch, val["acc"])
        if val["acc"] > best_acc:
            best_acc = val["acc"]
            save_checkpoint(best_path, model.state_dict())
            with open(f"{best_path}.json", "w") as f:
                json.dump({"acc": best_acc, "epoch": epoch}, f)
    print(f"best acc {best_acc:.2f}")
    return best_acc


if __name__ == "__main__":
    main()
