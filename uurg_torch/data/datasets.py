"""Dataset loaders: CIFAR-10/100, SVHN, STL-10, Tiny-ImageNet, image
folders and the synthetic stand-in.

This package's own copy of the numpy code in ``uurg_tpu/data/datasets.py``.
Same seed, same arrays. The loaders read the standard on-disk formats
(Classification/dataset/{cifar10,cifar100,SVHN,tinyimagenet}.py) and raise
``FileNotFoundError`` when the files are missing, so the classification
CLIs fall back to the stand-in. Pillow and SciPy are imported at the call,
so only the folder reader and the SVHN reader need them.
"""
from __future__ import annotations

import os
import pickle
from typing import Sequence

import numpy as np

from uurg_torch.core.registry import Registry
from uurg_torch.data.arrays import ArrayDataset

dataset_registry = Registry("dataset")


def synthetic_dataset(n: int = 512, resolution: int = 32, channels: int = 3,
                      n_classes: int = 10, seed: int = 0,
                      base_seed: int | None = None,
                      class_affinity: float = 0.0,
                      noise_sigma: float = 0.1) -> ArrayDataset:
    """Class-structured fake images: each class has a distinct mean pattern
    so unlearning logic is exercised without a download.

    ``base_seed`` fixes the per-class mean patterns independently of the
    sample draw (pass the same one to share one class distribution between
    splits); with None they come from the label-advanced ``seed`` stream.
    ``class_affinity`` blends each class mean toward its ring successor;
    ``noise_sigma`` is the per-sample Gaussian noise around the mean."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n).astype(np.int64)
    base_rng = rng if base_seed is None else np.random.default_rng(base_seed)
    base = base_rng.random(
        (n_classes, resolution, resolution, channels)).astype(np.float32)
    if class_affinity > 0.0:
        a = float(class_affinity)
        base = (1.0 - a) * base + a * np.roll(base, -1, axis=0)
    noise = rng.normal(0, noise_sigma,
                       (n, resolution, resolution, channels))
    images = np.clip(base[labels] + noise.astype(np.float32), 0, 1)
    return ArrayDataset(images, labels)


def load_cifar10(root: str, train: bool = True) -> ArrayDataset:
    """Read cifar-10-batches-py pickle files -> NHWC uint8. The files are
    the dataset's own; unpickling runs code, so point ``root`` only at a
    trusted copy."""
    d = os.path.join(root, "cifar-10-batches-py")
    files = ([f"data_batch_{i}" for i in range(1, 6)] if train
             else ["test_batch"])
    xs, ys = [], []
    for fname in files:
        with open(os.path.join(d, fname), "rb") as f:
            entry = pickle.load(f, encoding="latin1")
        xs.append(entry["data"])
        ys.extend(entry.get("labels", entry.get("fine_labels")))
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return ArrayDataset(np.ascontiguousarray(x), np.asarray(ys, np.int64))


def load_cifar100(root: str, train: bool = True) -> ArrayDataset:
    """cifar-100-python pickle files -> NHWC uint8, fine labels. Unpickling
    runs code: point ``root`` only at a trusted copy."""
    d = os.path.join(root, "cifar-100-python")
    with open(os.path.join(d, "train" if train else "test"), "rb") as f:
        entry = pickle.load(f, encoding="latin1")
    x = np.asarray(entry["data"]).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return ArrayDataset(np.ascontiguousarray(x),
                        np.asarray(entry["fine_labels"], np.int64))


def load_svhn(root: str, train: bool = True) -> ArrayDataset:
    """SVHN ``{train,test}_32x32.mat`` -> NHWC uint8; label 10 is digit 0."""
    import scipy.io as sio

    fname = "train_32x32.mat" if train else "test_32x32.mat"
    mat = sio.loadmat(os.path.join(root, fname))
    x = np.transpose(mat["X"], (3, 0, 1, 2))            # HWCN -> NHWC
    y = mat["y"].astype(np.int64).squeeze()
    y[y == 10] = 0
    return ArrayDataset(np.ascontiguousarray(x), y)


def load_stl10(root: str, train: bool = True) -> ArrayDataset:
    """STL-10 binary files (96x96x3, each image CHW column-major) -> NHWC
    uint8, labels 0-9."""
    split = "train" if train else "test"
    with open(os.path.join(root, "stl10_binary", f"{split}_X.bin"), "rb") as f:
        x = np.frombuffer(f.read(), np.uint8).reshape(-1, 3, 96, 96)
        x = np.transpose(x, (0, 3, 2, 1))
    with open(os.path.join(root, "stl10_binary", f"{split}_y.bin"), "rb") as f:
        y = np.frombuffer(f.read(), np.uint8).astype(np.int64) - 1
    return ArrayDataset(np.ascontiguousarray(x), y)


def load_tinyimagenet(root: str, train: bool = True) -> ArrayDataset:
    """Tiny-ImageNet from ``tinyimagenet_{train,val}.npz`` ({'images',
    'labels'}) or the ``tiny-imagenet-200/{train,val}`` image folders at 64
    px (Classification/dataset/tinyimagenet.py:23-73)."""
    split = "train" if train else "val"
    npz = os.path.join(root, f"tinyimagenet_{split}.npz")
    if os.path.exists(npz):
        d = np.load(npz)
        return ArrayDataset(d["images"], d["labels"].astype(np.int64))
    folder = os.path.join(root, "tiny-imagenet-200", split)
    if os.path.isdir(folder):
        return load_image_folder(folder, 64, center_crop=False)
    raise FileNotFoundError(f"no TinyImageNet under {root}")


def load_image_folder(root: str, resolution: int,
                      class_names: Sequence[str] | None = None,
                      center_crop: bool = True) -> ArrayDataset:
    """ImageFolder-style loader (a subdirectory a class) -> NHWC uint8.

    ``class_names`` restricts the classes loaded while keeping the class to
    index map of ALL sorted subdirectories (DiT/unlearn_dataset.py:37-292
    TargetedImageFolder). Raises ``FileNotFoundError`` when no image is
    found."""
    from PIL import Image

    all_classes = sorted(
        d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    class_to_idx = {c: i for i, c in enumerate(all_classes)}
    wanted = class_names if class_names is not None else all_classes
    xs, ys = [], []
    for cname in wanted:
        cdir = os.path.join(root, cname)
        for fname in sorted(os.listdir(cdir)):
            if not fname.lower().endswith((".png", ".jpg", ".jpeg", ".webp")):
                continue
            img = Image.open(os.path.join(cdir, fname)).convert("RGB")
            if center_crop:
                img = _center_crop_resize(img, resolution)
            else:
                img = img.resize((resolution, resolution), Image.BICUBIC)
            xs.append(np.asarray(img, np.uint8))
            ys.append(class_to_idx[cname])
    if not xs:
        raise FileNotFoundError(f"no images under {root}")
    return ArrayDataset(np.stack(xs), np.asarray(ys, np.int64))


def _center_crop_resize(img, size: int):
    """ADM-style center crop (DiT/forget.py center_crop_arr): halve with a
    box filter while the short side is at least twice ``size``, resize
    bicubic so the short side is ``size``, crop the center."""
    from PIL import Image

    while min(img.size) >= 2 * size:
        img = img.resize((img.size[0] // 2, img.size[1] // 2), Image.BOX)
    scale = size / min(img.size)
    img = img.resize((round(img.size[0] * scale), round(img.size[1] * scale)),
                     Image.BICUBIC)
    arr = np.asarray(img)
    y = (arr.shape[0] - size) // 2
    x = (arr.shape[1] - size) // 2
    return Image.fromarray(arr[y:y + size, x:x + size])


dataset_registry.register("CIFAR10", load_cifar10)
dataset_registry.register("CIFAR100", load_cifar100)
dataset_registry.register("SVHN", load_svhn)
dataset_registry.register("STL10", load_stl10)
dataset_registry.register("TinyImagenet", load_tinyimagenet)
dataset_registry.register("synthetic", synthetic_dataset)
