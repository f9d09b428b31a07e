"""Per-scale trainable-parameter plans and per-block learning rates.

The port of the JAX package's `training/partition.py` (reference
train_image.py:51-83, train_video_baselines.py:64-83): which of {encode,
decoder, body[i]} (the baselines: {head, tail, body[i]}) train at a given
scale, and at which LR (lr_g * lr_scale ** depth-from-top).
`make_lr_plan` and `make_baseline_lr_plan` are copies; `apply_lr_plan`
freezes the rest with `requires_grad_(False)` and hands the optimizer the
trainable subtrees only, so frozen parameters get neither gradients nor
Adam moments.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch.nn as nn


def make_lr_plan(cfg, scale_idx: int, body_len: int) -> Dict:
    """Return {'encode': lr|None, 'decoder': lr|None, 'body': [lr|None]}."""
    enc_lr: Optional[float] = None
    dec_lr: Optional[float] = None
    body_lr: List[Optional[float]] = [None] * body_len

    def ladder(n: int) -> List[float]:
        # last n blocks, top block at lr_g, each lower block scaled by lr_scale
        return [cfg.lr_g * (cfg.lr_scale ** (n - 1 - i)) for i in range(n)]

    if not cfg.train_all:
        if cfg.vae_levels < scale_idx + 1:
            # GAN scales: only the last train_depth body blocks
            depth = min(cfg.train_depth, body_len - cfg.vae_levels + 1)
            depth = max(depth, 0)
            for i, lr in enumerate(ladder(depth)):
                body_lr[body_len - depth + i] = lr
        else:
            # VAE scales: encoder+decoder + last train_depth body blocks
            enc_lr = dec_lr = cfg.lr_g * (cfg.lr_scale ** scale_idx)
            depth = min(cfg.train_depth, body_len)
            for i, lr in enumerate(ladder(depth)):
                body_lr[body_len - depth + i] = lr
    else:
        if body_len < cfg.train_depth:
            enc_lr = dec_lr = cfg.lr_g * (cfg.lr_scale ** scale_idx)
            for i, lr in enumerate(ladder(body_len)):
                body_lr[i] = lr
        else:
            depth = cfg.train_depth
            for i, lr in enumerate(ladder(depth)):
                body_lr[body_len - depth + i] = lr

    return {"encode": enc_lr, "decoder": dec_lr, "body": body_lr}


def make_baseline_lr_plan(cfg, scale_idx: int, body_len: int,
                          has_head: bool = False,
                          has_tail: bool = False) -> Dict:
    """The baselines' plan (JAX partition.py:53-69): the last train_depth
    body stages at the LR ladder, the head while scale_idx < train_depth,
    the tail always at lr_g."""
    plan: Dict = {"body": [None] * body_len}
    depth = min(cfg.train_depth, body_len)
    for i in range(depth):
        plan["body"][body_len - depth + i] = \
            cfg.lr_g * (cfg.lr_scale ** (depth - 1 - i))
    if has_head:
        plan["head"] = (cfg.lr_g * (cfg.lr_scale ** scale_idx)
                        if scale_idx - cfg.train_depth < 0 else None)
    if has_tail:
        plan["tail"] = cfg.lr_g
    return plan


def apply_lr_plan(generator: nn.Module, plan: Dict) -> List[Dict]:
    """Set requires_grad on the generator's subtrees by the plan (its named
    top-level groups, then `body`, as JAX split_params reads it) and return
    the optimizer's param groups, one per learning rate."""
    subtrees = [(getattr(generator, name), lr) for name, lr in plan.items()
                if name != "body"]
    subtrees += list(zip(generator.body, plan["body"]))
    groups: Dict[float, List] = {}
    for module, lr in subtrees:
        module.requires_grad_(lr is not None)
        if lr is not None:
            groups.setdefault(lr, []).extend(module.parameters())
    return [{"params": params, "lr": lr} for lr, params in groups.items()]
