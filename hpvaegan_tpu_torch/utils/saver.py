"""Experiment directory layout, checkpoint and JSON IO (the pieces that
evaluation uses).

The port of the JAX package's `utils/saver.py`, reading and writing the JAX
package's formats: checkpoints are pickled numpy pytrees
({'params': ..., 'state': ...}) named netG_<k>.ckpt, and `intermediate.json`
carries {noise_amps, scale_idx} (reference: train_image.py:206-210).
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Any, Dict, Optional


def load_pytree(filename: str):
    """Unpickle a checkpoint this project wrote (pickle runs code: load
    only checkpoints from a trusted run)."""
    with open(filename, "rb") as f:
        return pickle.load(f)


def resolve_finalized_scale(inter: dict, what: str = "evaluate") -> int:
    """The scale whose netG_<k>.ckpt exists, per the intermediate.json
    contract: a mid-scale 'inflight' marker names the scale in progress,
    whose finalized checkpoint does not exist yet — serve the previous one
    (an error at scale 0: nothing is finalized)."""
    scale_idx = int(inter["scale_idx"])
    if inter.get("inflight"):
        if scale_idx == 0:
            raise RuntimeError(
                f"training is mid-scale 0 (inflight checkpoint only); "
                f"no finalized scale to {what} yet")
        scale_idx -= 1
    return scale_idx


class DataSaver:
    """The eval side of the JAX package's DataSaver: an existing experiment
    dir (cfg.experiment_dir, set by evaluation.hydrate_config) and its eval/
    subdir. Creating new experiment dirs belongs to training."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.experiment_dir = cfg.experiment_dir
        if not os.path.isdir(self.experiment_dir):
            raise FileNotFoundError(
                f"experiment dir {self.experiment_dir!r} does not exist")
        self.eval_dir = os.path.join(self.experiment_dir, "eval")
        os.makedirs(self.eval_dir, exist_ok=True)

    def save_json(self, obj: Dict[str, Any], filename: str) -> None:
        dst = os.path.join(self.experiment_dir, filename)
        tmp = dst + ".tmp"
        with open(tmp, "w") as f:
            json.dump(obj, f)
        os.replace(tmp, dst)

    def load_json(self, filename: str, path: Optional[str] = None):
        path = path or self.experiment_dir
        with open(os.path.join(path, filename), "r") as f:
            return json.load(f)
