"""Comparative unlearning protocol: Baseline / Retrain / method rows.

Port of ``uurg_tpu/unlearn/protocol.py``. The reference's deliverable is the
comparison table: every unlearning method evaluated against Baseline (the
pretrained model, no unlearning) and Retrain (re-trained on retain only) on
retain / forget / test accuracy, the membership-inference probes and the JS
divergence to Retrain on the forget set (Classification/main_random.py
:113-148, Classification/evaluation/mia.py). This module runs that protocol
from ONE pretrained model and emits one row per method.

In ``forget_mode='class'`` the test set is also split by the forgotten label
(``test_retain_acc``, ``test_forget_acc``).
"""
from __future__ import annotations

import copy
import csv
import logging
import os
import time
from typing import Callable, Sequence

import numpy as np
import torch

from uurg_torch.data.arrays import ArrayDataset, epoch_batches, infinite_batches
from uurg_torch.data.splits import class_forget_split, random_forget_split
from uurg_torch.eval.features import softmax
from uurg_torch.eval.js_div import get_js_divergence
from uurg_torch.eval.mia import membership_attack_prob, svc_mia
from uurg_torch.models.init import init_classifier
from uurg_torch.train.optim import make_optimizer
from uurg_torch.unlearn.methods.classification import (UnlearnContext,
                                                       unlearn_method_registry)
from uurg_torch.workloads.classification import Classifier

log = logging.getLogger("uurg.protocol")


def pretrain(cls: Classifier, model: torch.nn.Module, train_ds: ArrayDataset,
             *, epochs: int = 30, lr: float = 0.1, batch_size: int = 256,
             seed: int = 0, transform: Callable | None = None
             ) -> torch.nn.Module:
    """SGD-momentum supervised training with the per-epoch cosine applied
    to the iteration counter (the main_pretrain.py recipe, Classification/
    main_pretrain.py:58-89), in place; returns ``model``."""
    opt = make_optimizer("sgd", model.parameters(), lr, momentum=0.9,
                         weight_decay=5e-4)
    steps_per_epoch = max(1, -(-len(train_ds) // batch_size))
    step = cls.make_train_step(opt, lr_schedule=lambda it: lr * (
        1.0 + np.cos(np.pi * (it // steps_per_epoch) / epochs)) / 2.0)
    it_count = 0
    for epoch in range(epochs):
        it = infinite_batches(train_ds, batch_size, seed=seed + epoch,
                              transform=transform)
        for _ in range(steps_per_epoch):
            metrics = step(model, cls.batch(*next(it)), it_count)
            it_count += 1
        if (epoch + 1) % max(1, epochs // 5) == 0:
            log.info("pretrain epoch %d/%d loss %.4f acc %.3f", epoch + 1,
                     epochs, float(metrics["loss"]), float(metrics["acc"]))
    return model


def evaluate(cls: Classifier, model: torch.nn.Module, retain: ArrayDataset,
             forget: ArrayDataset, test_ds: ArrayDataset,
             *, batch_size: int = 256,
             label_to_forget: int | None = None,
             return_forget_probs: bool = False,
             svc_mia_cap: int = 4000, seed: int = 0):
    """One comparison-table row: accuracies, the logistic MIA probe and the
    SVC-MIA forget-efficacy probe (Classification/main_random.py:113-148,
    evaluation/svc_mia.py:44-143).

    SVC-MIA (the reference's ``svc_mia_forget_efficacy``): the shadow
    attacker trains on a retain subset sized like the test set (members)
    against the test set (non-members); the forget set is the target, so the
    number is the fraction of forget samples read as NON-members (1.0 is
    perfect forgetting). ``svc_mia_cap`` bounds the fit; the subsets are
    drawn from ``np.random.default_rng(seed)``.

    With ``return_forget_probs`` returns ``(row, forget_softmax)`` for the
    caller's JS divergence."""
    def batches(ds):
        return epoch_batches(ds, batch_size)

    row = {
        "retain_acc": cls.validate(model, batches(retain))["acc"],
        "forget_acc": cls.validate(model, batches(forget))["acc"],
        "test_acc": cls.validate(model, batches(test_ds))["acc"],
    }
    if label_to_forget is not None:
        t_retain, t_forget = class_forget_split(test_ds, label_to_forget)
        row["test_retain_acc"] = cls.validate(model, batches(t_retain))["acc"]
        row["test_forget_acc"] = cls.validate(model, batches(t_forget))["acc"]
    rp, rl = cls.collect_logits(model, batches(retain))
    fp, fl = cls.collect_logits(model, batches(forget))
    tp, tl = cls.collect_logits(model, batches(test_ds))
    r_soft, f_soft, t_soft = softmax(rp), softmax(fp), softmax(tp)
    row["mia"] = membership_attack_prob(r_soft, rl, f_soft, fl, t_soft, tl)

    n_shadow = min(len(rl), len(tl), svc_mia_cap)
    rng = np.random.default_rng(seed)
    r_idx = rng.choice(len(rl), n_shadow, replace=False)
    t_idx = (rng.choice(len(tl), n_shadow, replace=False)
             if len(tl) > n_shadow else np.arange(len(tl)))
    f_idx = (rng.choice(len(fl), svc_mia_cap, replace=False)
             if len(fl) > svc_mia_cap else np.arange(len(fl)))
    empty = (np.zeros((0,) + f_soft.shape[1:]), np.zeros((0,), fl.dtype))
    sv = svc_mia((r_soft[r_idx], rl[r_idx]), (t_soft[t_idx], tl[t_idx]),
                 empty, (f_soft[f_idx], fl[f_idx]))
    for metr, v in sv.items():  # the reference's columns: svc_mia_<metr>
        row[f"svc_mia_{metr}"] = v
    if return_forget_probs:
        return row, f_soft
    return row


def run_comparison(model: torch.nn.Module, train_ds: ArrayDataset,
                   test_ds: ArrayDataset, *,
                   methods: Sequence[str] = ("Baseline", "Retrain", "SFRon"),
                   forget_mode: str = "class", label_to_forget: int = 0,
                   forget_ratio: float = 0.1, batch_size: int = 256,
                   seed: int = 0, num_classes: int | None = None,
                   pretrain_epochs: int = 30, pretrain_lr: float = 0.1,
                   pretrained: bool = False,
                   transform: Callable | None = None,
                   overrides: dict[str, dict] | None = None,
                   csv_path: str | None = None,
                   save_path: str | None = None) -> list[dict]:
    """Pretrain once, run each method from those weights, evaluate each.

    ``model`` (on its device) gives the architecture; with ``pretrained`` it
    also gives the weights, else it is initialised from ``seed``
    (:func:`init_classifier`) and pretrained here. ``overrides`` maps a
    method name to its ``UnlearnContext.overrides``. Returns the rows (also
    appended to ``csv_path`` when given)."""
    overrides = overrides or {}
    if num_classes is None:
        num_classes = int(train_ds.labels.max()) + 1
    dev = next(model.parameters()).device
    cls = Classifier(dev)

    if forget_mode == "class":
        retain, forget = class_forget_split(train_ds, label_to_forget)
        probe_label = label_to_forget
    else:
        retain, forget = random_forget_split(train_ds, forget_ratio, seed,
                                             save_path)
        probe_label = None

    def init_fn(s: int) -> torch.nn.Module:
        fresh = copy.deepcopy(model).cpu()
        return init_classifier(torch.Generator().manual_seed(s), fresh,
                               resolution=train_ds.images.shape[1]).to(dev)

    if not pretrained:
        model = init_fn(seed)
        log.info("pretraining %d epochs on the full train set...",
                 pretrain_epochs)
        pretrain(cls, model, train_ds, epochs=pretrain_epochs,
                 lr=pretrain_lr, batch_size=batch_size, seed=seed,
                 transform=transform)

    rows = []
    forget_probs: dict[str, np.ndarray] = {}
    for name in methods:
        method = unlearn_method_registry.get(name)
        ctx = UnlearnContext(
            classifier=cls, model=model, retain_train=retain,
            forget_train=forget, num_classes=num_classes,
            batch_size=batch_size, seed=seed, save_path=save_path,
            transform=transform, init_fn=init_fn,
            overrides=dict(overrides.get(name, {})))
        t0 = time.time()
        unlearned = method(ctx)
        row = {"method": name, "unlearn_time": round(time.time() - t0, 2)}
        metrics, forget_probs[name] = evaluate(
            cls, unlearned, retain, forget, test_ds, batch_size=batch_size,
            label_to_forget=probe_label, return_forget_probs=True)
        row.update(metrics)
        log.info("%s: %s", name,
                 {k: (round(v, 4) if isinstance(v, float) else v)
                  for k, v in row.items()})
        rows.append(row)

    # JS divergence to the retrained model on the forget set, the
    # reference's third comparison metric (evaluation/js_div.py:17-29);
    # defined only when Retrain is part of the comparison
    if "Retrain" in forget_probs:
        for row in rows:
            row["js_div"] = get_js_divergence(
                forget_probs[row["method"]], forget_probs["Retrain"])

    if csv_path:
        _append_rows_csv(csv_path, rows)
    return rows


def _append_rows_csv(csv_path: str, rows: list[dict]) -> None:
    """Append rows, reconciling columns with an existing header: when the
    new rows add columns the file is rewritten under the merged header;
    missing values are left blank (runs differ in ``js_div`` and the class
    mode's test columns)."""
    os.makedirs(os.path.dirname(csv_path) or ".", exist_ok=True)
    new_fields = list(dict.fromkeys(k for r in rows for k in r))
    old_rows: list[dict] = []
    fields = new_fields
    if os.path.exists(csv_path):
        with open(csv_path, newline="") as f:
            reader = csv.DictReader(f)
            old_fields = reader.fieldnames or []
            extra = [k for k in new_fields if k not in old_fields]
            if extra:
                old_rows = list(reader)
            fields = list(old_fields) + extra
        if not extra:
            with open(csv_path, "a", newline="") as f:
                csv.DictWriter(f, fieldnames=fields,
                               restval="").writerows(rows)
            return
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields, restval="")
        w.writeheader()
        w.writerows(old_rows + rows)


def assert_efficacy(rows: list[dict], *, forget_floor: float = 85.0,
                    collapse_ceiling: float = 25.0,
                    retain_slack: float = 8.0,
                    js_margin: float = 0.0) -> None:
    """Directionality gate over a Baseline/Retrain/<methods> comparison.

    Accuracies are percent, MIA a fraction. Baseline must remember the
    forget split (acc >= forget_floor) and have learned retain; every other
    method must collapse forget accuracy (<= collapse_ceiling), hold retain
    (and the class mode's test-retain) accuracy within ``retain_slack``
    points of Baseline, keep MIA within 0.05 above Baseline's and SVC-MIA
    confidence within 0.05 below it, and (all but Retrain) sit closer to
    Retrain than Baseline does in JS divergence by the margin
    ``js_margin``. Raises AssertionError with the numbers."""
    by = {r["method"]: r for r in rows}
    base = by.pop("Baseline")
    assert base["forget_acc"] >= forget_floor, \
        f"Baseline forgot on its own: forget_acc={base['forget_acc']:.3f}"
    assert base["retain_acc"] >= forget_floor, \
        f"Baseline never learned: retain_acc={base['retain_acc']:.3f}"
    for name, r in by.items():
        assert r["forget_acc"] <= collapse_ceiling, \
            (f"{name} did not forget: forget_acc={r['forget_acc']:.3f} "
             f"(Baseline {base['forget_acc']:.3f})")
        assert r["retain_acc"] >= base["retain_acc"] - retain_slack, \
            (f"{name} damaged retain: {r['retain_acc']:.3f} vs Baseline "
             f"{base['retain_acc']:.3f}")
        if "test_retain_acc" in r:
            assert r["test_retain_acc"] >= base["test_retain_acc"] - \
                retain_slack, \
                (f"{name} damaged test generalization: "
                 f"{r['test_retain_acc']:.3f} vs {base['test_retain_acc']:.3f}")
        assert r["mia"] <= base["mia"] + 0.05, \
            (f"{name} MIA {r['mia']:.3f} above Baseline {base['mia']:.3f}")
        if "svc_mia_confidence" in r and "svc_mia_confidence" in base:
            assert r["svc_mia_confidence"] >= \
                base["svc_mia_confidence"] - 0.05, \
                (f"{name} svc_mia_confidence {r['svc_mia_confidence']:.3f} "
                 f"below Baseline {base['svc_mia_confidence']:.3f}")
        if "js_div" in r and "js_div" in base and name != "Retrain":
            bound = base["js_div"] * (1.0 - js_margin) + 1e-6
            assert r["js_div"] <= bound, \
                (f"{name} js_div {r['js_div']:.4f} above "
                 f"{bound:.4f} (Baseline {base['js_div']:.4f}, "
                 f"margin {js_margin:.0%})")
