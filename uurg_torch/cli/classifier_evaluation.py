"""UA classifier evaluation CLI, the flags of ``cli/classifier_evaluation.py``
(DDPM/classifier_evaluation.py:16-147) plus ``--device``.

Run as ``python -m uurg_torch.cli.classifier_evaluation SAMPLES
--classifier_ckpt PROBE.pth``: the fine-tuned probe (a ResNet-34 with the
ImageNet stem, bf16 convolutions, BatchNorm in fp32) over generated
forget-class samples; prints the average entropy, the average probability
of the forgotten class and the forget-class accuracy (UA), and appends them
to ``--csv``. ``--classifier_ckpt`` is a torch ``.pth`` in torchvision or
reference-CIFAR layout; an Orbax directory of the JAX package raises (it
needs JAX to read). Pillow is needed only to read a folder of images.
"""
from __future__ import annotations

import argparse
import logging


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("sample_path", type=str,
                   help="folder/npz of generated forget-class samples")
    p.add_argument("--classifier_ckpt", type=str, required=True)
    p.add_argument("--label_of_forgotten_class", type=int, default=0)
    p.add_argument("--num_classes", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--image_size", type=int, default=224,
                   help="resolution samples are resized to before the probe "
                        "— MUST match the probe's training resolution "
                        "(224 for the reference's fine-tuned ResNet-34, "
                        "train_classifier.py --image_size otherwise)")
    p.add_argument("--csv", type=str,
                   default="results/cifar10/forget/result.csv")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a GPU) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    import torch

    from uurg_torch.cli.evaluator import append_csv, load_images
    from uurg_torch.core.device import resolve_device
    from uurg_torch.eval.classifier_eval import classifier_probe
    from uurg_torch.io.tv_resnet_interop import load_torch_resnet_checkpoint
    from uurg_torch.models.resnet import ResNet34

    device = resolve_device(args.device)
    model = ResNet34(args.num_classes, dtype=torch.bfloat16,
                     imagenet_stem=True)
    model.load_state_dict(load_torch_resnet_checkpoint(args.classifier_ckpt),
                          strict=True)
    model = model.to(device).eval()

    images = load_images(args.sample_path)
    metrics = classifier_probe(model, images, args.label_of_forgotten_class,
                               args.batch_size, resize_to=args.image_size,
                               device=device)
    print("Average entropy:", metrics["avg_entropy"])
    print("Average prob of forgotten class:", metrics["avg_prob_forgotten"])
    print("Forget accuracy (UA):", metrics["forget_accuracy"])
    append_csv(args.csv, {"sample": args.sample_path, **metrics})


if __name__ == "__main__":
    main()
