"""Experiment directory layout, checkpoint and JSON IO.

The port of the JAX package's `utils/saver.py`, reading and writing the JAX
package's formats (reference src/utils/saver.py:21-92):
  <run_dir>/<clip_name>/<checkname>/experiment_<n>/
with the run id one past the numeric maximum of the existing ones.
Checkpoints are pickled numpy pytrees ({'params': ..., 'state': ...}) named
netG_<k>.ckpt / netD_<k>.ckpt, and `intermediate.json` carries
{noise_amps, scale_idx} (reference: train_image.py:206-210).

The port's marker has no "key": the port has no JAX PRNG key to record. A
resume by the JAX package therefore reads it as a keyless, reference-style
marker and retrains the marker's scale from its checkpoint (JAX
training/trainer.py:499-534) instead of continuing at the next one.
"""

from __future__ import annotations

import glob
import json
import os
import pickle
from typing import Any, Dict, Optional


def save_pytree(tree, filename: str) -> None:
    """Pickle a numpy pytree atomically (tmp + rename): a kill mid-write
    leaves the previous file whole."""
    tmp = filename + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(tree, f)
    os.replace(tmp, filename)


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


def new_experiment_dir(cfg) -> str:
    """run_dir/<clip>/<checkname>/experiment_<n>, n one past the numeric
    maximum (a string sort would rank experiment_9 above experiment_10).
    The clip is named after cfg.image_path, or cfg.video_path when that is
    empty (JAX utils/saver.py:152-157)."""
    path = cfg.image_path or cfg.video_path
    if not path:
        raise AttributeError("cfg needs image_path or video_path")
    clip = ".".join(os.path.basename(path).split(".")[:-1])
    directory = os.path.join(cfg.run_dir, clip, cfg.checkname)
    ids = [int(r.split("_")[-1])
           for r in glob.glob(os.path.join(directory, "experiment_*"))
           if r.split("_")[-1].isdigit()]
    return os.path.join(directory,
                        "experiment_{}".format(max(ids) + 1 if ids else 0))


class DataSaver:
    """An experiment dir and its eval/ subdir. Evaluation opens an existing
    one (cfg.experiment_dir, set by evaluation.hydrate_config); training
    (`create=True`) makes a new one under cfg.run_dir."""

    def __init__(self, cfg, create: bool = False):
        self.cfg = cfg
        if create:
            self.experiment_dir = new_experiment_dir(cfg)
            os.makedirs(self.experiment_dir)
        else:
            self.experiment_dir = cfg.experiment_dir
            if not os.path.isdir(self.experiment_dir):
                raise FileNotFoundError(
                    f"experiment dir {self.experiment_dir!r} does not exist")
        self.eval_dir = os.path.join(self.experiment_dir, "eval")
        os.makedirs(self.eval_dir, exist_ok=True)

    def save_checkpoint(self, tree, filename: str) -> None:
        save_pytree(tree, os.path.join(self.experiment_dir, filename))

    def finalize_scale(self, scale_idx: int, noise_amps, g_tree,
                       d_tree=None) -> None:
        """Scale-end artifacts in crash order: netG, netD, then the marker,
        so that a kill before the marker leaves the previous marker with its
        checkpoints on disk."""
        self.save_checkpoint(g_tree, f"netG_{scale_idx}.ckpt")
        if d_tree is not None:
            self.save_checkpoint(d_tree, f"netD_{scale_idx}.ckpt")
        self.save_json({"noise_amps": [float(a) for a in noise_amps],
                        "scale_idx": scale_idx}, "intermediate.json")

    def load_checkpoint(self, filename: str, path: Optional[str] = None):
        return load_pytree(os.path.join(path or self.experiment_dir, filename))

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
