"""Experiment directory layout, checkpoint and JSON IO.

The port of the JAX package's `utils/saver.py`, reading and writing the JAX
package's formats (reference src/utils/saver.py:21-92):
  <run_dir>/<clip_name>/<checkname>/experiment_<n>/
with the run id one past the numeric maximum of the existing ones.
Checkpoints are pickled numpy pytrees ({'params': ..., 'state': ...}) named
netG_<k>.ckpt / netD_<k>.ckpt, and `intermediate.json` carries
{noise_amps, scale_idx} (reference: train_image.py:206-210).

The port's own resume state is written with `torch.save`, beside them:
  torch_rng_<k>.pt   the weight generator's and the NoiseSource's states
                     at the end of scale k; the marker names it in
                     "torch_rng", which marks scale k as complete for the
                     port's resume (training/trainer.py)
  inflight_<k>.ckpt  mid-scale (--ckpt-interval): G and D state_dicts,
                     both optimizers, the generator states and the
                     iteration; the marker then also holds "inflight" and
                     "inflight_iter", the fields the JAX package writes
The marker never holds a "key": the JAX package would read one as its PRNG
key and continue at the next scale. Without it, a resume by the JAX package
reads a port marker as a reference-style one and retrains the marker's
scale from its checkpoint (JAX training/trainer.py:499-534).
"""

from __future__ import annotations

import glob
import json
import os
import pickle
from typing import Any, Dict, Optional

import torch

# the first bytes of a torch.save archive (a zip file)
_TORCH_MAGIC = b"PK\x03\x04"


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


def save_torch(obj, filename: str) -> None:
    """torch.save atomically (tmp + rename)."""
    tmp = filename + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, filename)


def load_inflight(path: str) -> Dict[str, Any]:
    """A port inflight_<k>.ckpt (or torch_rng_<k>.pt), tensors on the CPU.
    `weights_only` unpickles tensors and plain containers only; a file that
    is not a torch archive (the JAX package's inflight_<k>.ckpt pickles its
    ScaleTrainState and would import jax) is refused before anything is
    unpickled."""
    with open(path, "rb") as f:
        magic = f.read(len(_TORCH_MAGIC))
    if magic != _TORCH_MAGIC:
        raise ValueError(
            f"{path} is not a torch archive (a JAX package inflight "
            "checkpoint?); the port resumes only from its own inflight "
            "checkpoints, or from a finalized netG_<k>.ckpt")
    return torch.load(path, map_location="cpu", weights_only=True)


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

    def save_inflight(self, scale_idx: int, payload: Dict[str, Any],
                      iteration: int, noise_amps) -> None:
        """Mid-scale checkpoint (--ckpt-interval) in crash order: the
        checkpoint (atomic), then the marker naming it (atomic), so that a
        kill anywhere leaves a consistent pair (JAX utils/saver.py:188-197).
        `payload` is the trainer's state; the iteration is added here."""
        name = f"inflight_{scale_idx}.ckpt"
        save_torch({**payload, "iter": int(iteration)},
                   os.path.join(self.experiment_dir, name))
        self.save_json({"noise_amps": [float(a) for a in noise_amps],
                        "scale_idx": scale_idx, "inflight": name,
                        "inflight_iter": int(iteration)}, "intermediate.json")

    def finalize_scale(self, scale_idx: int, noise_amps, g_tree,
                       d_tree=None, rng: Optional[Dict[str, Any]] = None
                       ) -> None:
        """Scale-end artifacts in crash order: netG, netD, torch_rng_<k>.pt
        (`rng`: the generator states at the end of the scale), the marker,
        then the drop of inflight_<k>.ckpt. A kill before the marker leaves
        the previous marker with its checkpoints on disk."""
        self.save_checkpoint(g_tree, f"netG_{scale_idx}.ckpt")
        if d_tree is not None:
            self.save_checkpoint(d_tree, f"netD_{scale_idx}.ckpt")
        marker = {"noise_amps": [float(a) for a in noise_amps],
                  "scale_idx": scale_idx}
        if rng is not None:
            marker["torch_rng"] = f"torch_rng_{scale_idx}.pt"
            save_torch(rng, os.path.join(self.experiment_dir,
                                         marker["torch_rng"]))
        self.save_json(marker, "intermediate.json")
        inflight = os.path.join(self.experiment_dir,
                                f"inflight_{scale_idx}.ckpt")
        if os.path.exists(inflight):
            os.remove(inflight)

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
