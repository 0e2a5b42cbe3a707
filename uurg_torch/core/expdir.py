"""Experiment directories: timestamped, hyperparameter-encoding run dirs in
the reference layout (DDPM/functions/__init__.py:30-91).

Port of ``uurg_tpu/core/expdir.py``:
  pretrain/retrain: <exp>/<ds>/<mode>/<YYYY_MM_DD_HHMMSS>/{logs,ckpts}
  sfron:  <exp>/<ds>/forget_<label>/<method>_<loss[lambd]>/
          f<fa><decay>_r<ra>_lr<lr>/<ts>/{logs,ckpts}
A copy of the merged config goes to logs/config.yaml, written by
:func:`dump_yaml` (no PyYAML): it reads back to the same dict under
``yaml.safe_load`` and the port's reader
(:func:`uurg_torch.core.config.load_yaml`).
"""
from __future__ import annotations

import json
import math
import os
import re
from datetime import datetime

from uurg_torch.core.config import resolve_plain

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
        fp.write(dump_yaml(dump))
    return root


# strings written plain: no quote, indicator, comment or flow character,
# nothing that reads as a number (a digit, sign or dot first) or ends in a
# space; the rest must still resolve to a string
_PLAIN = re.compile(r"[A-Za-z_/][A-Za-z0-9_./-]*(?: [A-Za-z0-9_./-]+)*\Z")


def _scalar(value) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        # yaml/representer.py SafeRepresenter.represent_float: a float
        # needs a dot to read back as one
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(value, str):
        if _PLAIN.match(value) and resolve_plain(value) == "str":
            return value
        # a JSON string is a YAML double-quoted scalar (ASCII, escaped)
        return json.dumps(value)
    raise TypeError(f"cannot write {type(value).__name__} {value!r} to YAML")


def _flow(value) -> str:
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(_flow(v) for v in value) + "]"
    if isinstance(value, dict):
        return "{" + ", ".join(f"{_scalar(k)}: {_flow(v)}"
                               for k, v in value.items()) + "}"
    return _scalar(value)


def dump_yaml(data: dict, indent: int = 0) -> str:
    """``data`` (a dict of dicts, lists, tuples, strings, numbers, booleans
    and None) as YAML: block mappings, flow lists, strings quoted where a
    reader would take them for something else."""
    if not data:
        return "{}\n"
    lines = []
    pad = " " * indent
    for key, value in data.items():
        head = f"{pad}{_scalar(key)}:"
        if isinstance(value, dict) and value:
            lines.append(head + "\n" + dump_yaml(value, indent + 2))
        else:
            lines.append(f"{head} {_flow(value)}\n")
    return "".join(lines)
