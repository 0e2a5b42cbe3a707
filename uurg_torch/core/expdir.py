"""Experiment directories: timestamped, hyperparameter-encoding run dirs in
the reference layout (DDPM/functions/__init__.py:30-91).

Port of ``uurg_tpu/core/expdir.py``:
  pretrain/retrain: <exp>/<ds>/<mode>/<YYYY_MM_DD_HHMMSS>/{logs,ckpts}
  sfron:  <exp>/<ds>/forget_<label>/<method>_<loss[lambd]>/
          f<fa><decay>_r<ra>_lr<lr>/<ts>/{logs,ckpts}
A copy of the merged config goes to logs/config.yaml (needs PyYAML, which
is imported only here).
"""
from __future__ import annotations

import os
from datetime import datetime

_FORGET_MODES = ("sfron", "sa", "salun", "saliency_unlearn")


def _timestamp() -> str:
    return datetime.now().strftime("%Y_%m_%d_%H%M%S")


def run_dir_for(args, config, *, exp_root: str = "results") -> str:
    """Compute (but do not create) the reference-encoded run directory."""
    ds = config.data.dataset.lower()
    mode = getattr(args, "mode", "pretrain")
    if mode not in _FORGET_MODES:
        return os.path.join(exp_root, ds, mode, _timestamp())
    lr = config.optim.lr
    fa = getattr(args, "forget_alpha", 0.0)
    ra = getattr(args, "remain_alpha", 1.0)
    label = getattr(args, "label_to_forget", 0)
    if mode == "sfron":
        loss = getattr(args, "unlearn_loss", "adaga")
        if loss == "adaga":
            # the reference suffixes the adaptive-loss exponent
            loss = f"{loss}{config.training.get('gamma', config.training.get('lambd', 0.5))}"
        return os.path.join(
            exp_root, ds, f"forget_{label}",
            f"{getattr(args, 'method', 'ron')}_{loss}",
            f"f{fa}{getattr(args, 'decay_forget_alpha', False)}_r{ra}_lr{lr}",
            _timestamp())
    return os.path.join(exp_root, ds, f"forget_{label}", mode,
                        f"f{fa}_r{ra}_lr{lr}", _timestamp())


def setup_run_dirs(args, config, *, exp_root: str = "results") -> str:
    """Create the run tree (logs/ + ckpts/), record it on the config
    (``exp_root_dir``/``log_dir``/``ckpt_dir``) and dump logs/config.yaml.
    Returns the run root."""
    import yaml

    root = run_dir_for(args, config, exp_root=exp_root)
    log_dir = os.path.join(root, "logs")
    ckpt_dir = os.path.join(root, "ckpts")
    os.makedirs(log_dir, exist_ok=True)
    os.makedirs(ckpt_dir, exist_ok=True)
    config.exp_root_dir = root
    config.log_dir = log_dir
    config.ckpt_dir = ckpt_dir
    dump = dict(config.to_dict(), args=vars(args).copy())
    with open(os.path.join(log_dir, "config.yaml"), "w") as fp:
        yaml.safe_dump(dump, fp, default_flow_style=None)
    return root
