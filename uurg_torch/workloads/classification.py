"""Classification workload: classifier training, evaluation, and the
building blocks every unlearning method shares.

Port of ``uurg_tpu/workloads/classification.py`` (reference:
Classification/trainer/{train,val}.py, Classification/utils.py and the loss
definitions under Classification/unlearn/). Where the JAX package passes
``params`` and ``batch_stats`` beside a stateless module, a model here is
an ``nn.Module`` that holds both: train mode updates its BatchNorm buffers
in place, eval mode reads them and never writes them.

Batches are ``(images, labels)``: float images NHWC in [0, 1] as the data
streams give them (numpy arrays or tensors) and integer labels. The
classifier moves them to its device and hands the model NCHW.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

import numpy as np
import torch
import torch.nn.functional as F

from uurg_torch.diffusion.losses import adaptive_loss
from uurg_torch.train.optim import set_lr


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  keepdim: bool = False) -> torch.Tensor:
    per = F.cross_entropy(logits.float(), labels.long(), reduction="none")
    return per if keepdim else per.mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Top-1 accuracy in percent."""
    return (logits.argmax(-1) == labels).float().mean() * 100.0


@dataclasses.dataclass
class Classifier:
    """Applies a model in train or eval mode on ``device`` and builds the
    losses and steps of the unlearning methods."""

    device: torch.device

    def batch(self, x, y) -> tuple[torch.Tensor, torch.Tensor]:
        """A host or device batch as (float32 NHWC images, int64 labels) on
        the classifier's device."""
        x, y = (torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v)
                else v for v in (x, y))
        return (x.to(self.device, torch.float32, non_blocking=True),
                y.to(self.device, torch.long, non_blocking=True))

    @staticmethod
    def train_apply(model: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
        """Logits in train mode; the BatchNorm buffers move."""
        model.train()
        return model(x.permute(0, 3, 1, 2))

    @staticmethod
    def eval_apply(model: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
        model.eval()
        return model(x.permute(0, 3, 1, 2))

    # -- loss builders: fn(model, batch, generator) -> loss to MINIMIZE ----

    def ce_loss_fn(self) -> Callable:
        def fn(model, batch, generator):
            return cross_entropy(self.train_apply(model, batch[0]), batch[1])
        return fn

    def neg_adaptive_ce_loss_fn(self, lambd: float) -> Callable:
        """Forget objective: -AdaptiveLoss(CE), adaga ascent
        (Classification/unlearn/sfron.py:131-134,196-199)."""
        def fn(model, batch, generator):
            per = cross_entropy(self.train_apply(model, batch[0]), batch[1],
                                keepdim=True)
            return -adaptive_loss(per, lambd, eps=1e-15)
        return fn

    def neg_ce_loss_fn(self) -> Callable:
        """Plain gradient-ascent forget objective (``unlearn_loss=ga``)."""
        def fn(model, batch, generator):
            return -cross_entropy(self.train_apply(model, batch[0]), batch[1])
        return fn

    # -- steps -------------------------------------------------------------

    def make_train_step(self, optimizer: torch.optim.Optimizer,
                        lr_schedule: Callable | None = None):
        """Standard supervised step (pretrain, retrain, finetune):
        ``step(model, batch, it) -> {"loss", "acc"}``, ``lr_schedule(it)``
        setting the learning rate first."""

        def step(model, batch, it: int) -> dict:
            if lr_schedule is not None:
                set_lr(optimizer, lr_schedule(it))
            optimizer.zero_grad(set_to_none=True)
            logits = self.train_apply(model, batch[0])
            loss = cross_entropy(logits, batch[1])
            loss.backward()
            optimizer.step()
            return {"loss": loss.detach(),
                    "acc": accuracy(logits.detach(), batch[1])}

        return step

    @torch.no_grad()
    def validate(self, model: torch.nn.Module, batches: Iterable) -> dict:
        """Top-1 (percent) and loss averaged over samples, ragged last batch
        weighted by its size (Classification/trainer/val.py:7-26)."""
        tot, loss_sum, acc_sum = 0, 0.0, 0.0
        for x, y in batches:
            x, y = self.batch(x, y)
            logits = self.eval_apply(model, x)
            n = int(y.shape[0])
            tot += n
            loss_sum += float(cross_entropy(logits, y)) * n
            acc_sum += float(accuracy(logits, y)) * n
        return {"loss": loss_sum / max(tot, 1), "acc": acc_sum / max(tot, 1)}

    @torch.no_grad()
    def collect_logits(self, model: torch.nn.Module, batches: Iterable
                       ) -> tuple[np.ndarray, np.ndarray]:
        """Stacked float32 logits and labels over a loader (for MIA, JS)."""
        logits, labels = [], []
        for x, y in batches:
            logits.append(self.eval_apply(
                model, self.batch(x, y)[0]).float().cpu().numpy())
            labels.append(np.asarray(y))
        return np.concatenate(logits), np.concatenate(labels)
