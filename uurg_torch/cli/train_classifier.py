"""Train or fine-tune the UA probe classifier (DDPM/train_classifier.py),
with the flags of ``cli/train_classifier.py`` plus ``--device``: a
ResNet-34 with the ImageNet stem, bf16 convolutions, AdamW (lr 1e-3,
weight decay 1e-4) on CIFAR-10 (or the stand-in) resized to
``--image_size``.

Run as ``python -m uurg_torch.cli.train_classifier --save_path PROBE``. It
writes ``<save_path>/<dataset>_resnet34.pth``, a torchvision-layout state
dict that ``python -m uurg_torch.cli.classifier_evaluation SAMPLES
--classifier_ckpt PROBE/cifar10_resnet34.pth`` reads. (The JAX CLI writes an
Orbax directory ``<save_path>/<dataset>_resnet34`` instead, which the port
cannot read.) The batches are the JAX CLI's: ``infinite_batches`` seeded
``seed + epoch`` a epoch, random flips, optional pixel noise, then the
bilinear resize; ``len // batch_size`` steps an epoch.
"""
from __future__ import annotations

import argparse
import logging
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--dataset", type=str, default="CIFAR10")
    p.add_argument("--data_path", type=str, default="./data")
    p.add_argument("--num_classes", type=int, default=10)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save_path", type=str,
                   default="results/ua_classifier")
    p.add_argument("--noise_std", type=float, default=0.0,
                   help="Gaussian pixel-noise augmentation; makes the probe "
                        "robust to generative-sample artifacts (the "
                        "reference probe gets this robustness from "
                        "fine-tuning on real data at 224px)")
    p.add_argument("--torch_init", type=str, default=None,
                   help="locally-supplied torchvision ResNet-34 .pth to "
                        "start fine-tuning from (the reference probe uses "
                        "pretrained=True, DDPM/train_classifier.py)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a GPU) or cpu")
    return p.parse_args(argv)


def load_train_data(args):
    """The training split, or the stand-in (2,048 images of base seed 0,
    the DDPM runner's, so the probe recognises generated classes)."""
    from uurg_torch.data.datasets import dataset_registry, synthetic_dataset

    try:
        return dataset_registry.get(args.dataset)(args.data_path, True)
    except FileNotFoundError:
        logging.warning("dataset missing — synthetic fallback")
        return synthetic_dataset(2048, 32, 3, args.num_classes, base_seed=0)


def build(args, device):
    """(model, classifier, optimizer, step): the probe initialised from
    ``--seed`` (flax's scheme) at ``--image_size``, overlaid with
    ``--torch_init``, and its AdamW train step."""
    import torch

    from uurg_torch.models import init_classifier
    from uurg_torch.models.resnet import ResNet34
    from uurg_torch.train.optim import make_optimizer
    from uurg_torch.workloads.classification import Classifier

    model = init_classifier(
        torch.Generator().manual_seed(args.seed),
        ResNet34(args.num_classes, dtype=torch.bfloat16, imagenet_stem=True),
        resolution=args.image_size)
    if args.torch_init:
        from uurg_torch.io.torch_classifier import (load_torch_classifier,
                                                    overlay_pretrained)
        overlay_pretrained(model, load_torch_classifier(args.torch_init,
                                                        "ResNet34"))
    model = model.to(device)
    cls = Classifier(device)
    opt = make_optimizer("adamw", model.parameters(), args.lr,
                         weight_decay=1e-4)
    return model, cls, opt, cls.make_train_step(opt)


def epoch_stream(args, train_ds, epoch: int, device):
    """The epoch's batches as the step takes them: (NHWC float images in
    [0, 1] at ``--image_size`` on ``device``, labels)."""
    import numpy as np

    from uurg_torch.data.arrays import infinite_batches, random_flip_batch
    from uurg_torch.eval.classifier_eval import resize_batch

    def aug(x, rng):
        x = random_flip_batch(x, rng)
        if args.noise_std > 0:
            x = np.clip(x + rng.normal(0, args.noise_std, x.shape)
                        .astype(np.float32), 0.0, 1.0)
        return x

    it = infinite_batches(train_ds, args.batch_size, seed=args.seed + epoch,
                          transform=aug)
    for _ in range(max(1, len(train_ds) // args.batch_size)):
        x, y = next(it)
        x = resize_batch((x * 255).astype(np.uint8), args.image_size, device)
        yield x.permute(0, 2, 3, 1), y


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    import torch

    from uurg_torch.core.device import resolve_device

    device = resolve_device(args.device)
    train_ds = load_train_data(args)
    model, cls, _, step = build(args, device)
    it_count = 0
    for epoch in range(args.epochs):
        for x, y in epoch_stream(args, train_ds, epoch, device):
            m = step(model, cls.batch(x, y), it_count)
            it_count += 1
        logging.info("epoch %d loss %.4f acc %.2f", epoch, float(m["loss"]),
                     float(m["acc"]))
    os.makedirs(args.save_path, exist_ok=True)
    path = os.path.join(args.save_path,
                        f"{args.dataset.lower()}_resnet34.pth")
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               path)
    print(f"saved {path}")
    return path


if __name__ == "__main__":
    main()
