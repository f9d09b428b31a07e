"""Optimizers: Adam with a per-tensor clip by norm for G, plain Adam for D.

The port of the JAX package's `optim.py` (reference ClippedAdam,
src/modules/optimizers.py:6-43, and nn.Adam, train_image.py:42). The clip is
per TENSOR, as `optim.py:20-37` there: each gradient is scaled by
min(1, clip / max(||g||, 1e-12)) on its own, not by the global norm of
`clip_grad_norm_`. `torch.optim.Adam`'s update, lr * (m / (1 - b1^t)) /
(sqrt(v) / sqrt(1 - b2^t) + eps), is optax `scale_by_adam` followed by -lr
in another order of the same algebra; tests/test_torch_training.py holds the
two together on identical gradients.

`--flat-opt` (the JAX package's `flat_adam`, optim.py:55-126 there) runs
the same clip and Adam on one flat float32 buffer: `FlatAdam` keeps m and v
as one tensor each, takes every per-tensor clip norm in one call and
updates them all at once. Its state_dict marks its param groups "flat", and
`load_optimizer_state` refuses to load one layout into the other.

Every optimizer here keeps its step count, and the bias corrections made
from it, on the parameters' device when they live on a card (Adam's
`capturable`), so that one captured step replays as the next step
(training/chunk.py); the eager iterations of a run on the card take the
same update, so a graph run and an eager one agree bit for bit. On the
CPU the step count stays a host tensor, as `torch.optim.Adam` wants it.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List

import torch

BETA2 = 0.999
EPS = 1e-8


def _clip_scales(grads: List[torch.Tensor], clip: float) -> torch.Tensor:
    """min(1, clip / max(||g||, 1e-12)) of every gradient, on the device."""
    norms = torch.stack(torch._foreach_norm(grads))
    return torch.clamp(clip / torch.clamp_min(norms, 1e-12), max=1.0)


def _on_card(params: List[torch.Tensor]) -> bool:
    """Whether Adam keeps its step on the parameters' device (capturable)."""
    return params[0].device.type == "cuda"


class ClippedAdam(torch.optim.Adam):
    """G optimizer: Adam after clipping each parameter's gradient to norm
    `grad_clip`, one param group per learning rate of the plan
    (training/partition.py::param_groups). A non-finite clip skips the clip
    (the JAX package's unclipped form)."""

    def __init__(self, param_groups: Iterable[Dict], beta1: float,
                 grad_clip: float = 5.0):
        param_groups = list(param_groups)
        super().__init__(param_groups, betas=(beta1, BETA2), eps=EPS,
                         capturable=_on_card(param_groups[0]["params"]))
        self.grad_clip = float(grad_clip)

    @torch.no_grad()
    def clip_(self) -> None:
        """Scale every gradient in place, with no read back to the host."""
        grads: List[torch.Tensor] = [p.grad for g in self.param_groups
                                     for p in g["params"] if p.grad is not None]
        if not grads or not math.isfinite(self.grad_clip):
            return
        for grad, scale in zip(grads, _clip_scales(grads,
                                                   self.grad_clip).unbind()):
            grad.mul_(scale)

    def step(self, closure=None):
        self.clip_()
        return super().step(closure)


def adam(params, lr: float, beta1: float) -> torch.optim.Adam:
    """D optimizer (reference nn.Adam, train_image.py:42)."""
    params = list(params)
    return torch.optim.Adam(params, lr=lr, betas=(beta1, BETA2), eps=EPS,
                            capturable=_on_card(params))


class FlatAdam(torch.optim.Optimizer):
    """ClippedAdam (or, with an infinite clip, plain Adam) on one flat
    float32 buffer: the gradients of every parameter, in param-group order,
    are concatenated, clipped per tensor, and one Adam update in
    `torch.optim.Adam`'s operation order runs over the whole buffer with
    each element's group learning rate. m and v are the state of the first
    parameter ("m", "v", "step"), so that state_dict / load_state_dict
    round-trip them; the step count and the bias corrections are tensors on
    the parameters' device, so that the step reads nothing from the host.
    Every parameter must have a gradient at each step."""

    def __init__(self, param_groups, beta1: float, grad_clip: float = 5.0,
                 lr: float = 0.0):
        super().__init__(param_groups, dict(lr=lr, flat=True))
        self.beta1 = float(beta1)
        self.grad_clip = float(grad_clip)
        params = self._params()
        self._sizes = [p.numel() for p in params]
        # each element's tensor and param group, for the per-tensor clip
        # scales and the per-group learning rates
        self._tensor_index = torch.repeat_interleave(
            torch.arange(len(params)), torch.tensor(self._sizes)
        ).to(params[0].device)
        self._group_index = torch.repeat_interleave(
            torch.arange(len(self.param_groups)),
            torch.tensor([sum(p.numel() for p in g["params"])
                          for g in self.param_groups])).to(params[0].device)
        # the groups' -lr, on the device once: a tensor made from host
        # numbers at every step would copy from pageable memory, which
        # waits for the queued work
        self._neg_lr = torch.tensor([-float(g["lr"])
                                     for g in self.param_groups],
                                    dtype=torch.float64
                                    ).to(params[0].device)

    def _params(self) -> List[torch.Tensor]:
        return [p for g in self.param_groups for p in g["params"]]

    @torch.no_grad()
    def step(self, closure=None):
        params = self._params()
        grads = [p.grad for p in params]
        if any(g is None for g in grads):
            raise RuntimeError("FlatAdam needs a gradient for every parameter")
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        if math.isfinite(self.grad_clip):
            flat.mul_(_clip_scales(grads, self.grad_clip)[self._tensor_index])
        state = self.state[params[0]]
        if not state:
            state["step"] = torch.zeros((), device=flat.device)
            state["m"] = torch.zeros_like(flat)
            state["v"] = torch.zeros_like(flat)
        state["step"] += 1
        # float64, as the host numbers they replace
        step = state["step"].double()
        m, v = state["m"], state["v"]
        m.lerp_(flat, 1 - self.beta1)
        v.mul_(BETA2).addcmul_(flat, flat, value=1 - BETA2)
        bias_correction1 = 1 - torch.pow(self.beta1, step)
        bias_correction2_sqrt = torch.sqrt(1 - torch.pow(BETA2, step))
        denom = (v.sqrt() / bias_correction2_sqrt.float()).add_(EPS)
        step_size = (self._neg_lr / bias_correction1).float()
        update = (m / denom).mul_(step_size[self._group_index])
        torch._foreach_add_(params, [u.view_as(p) for u, p in
                                     zip(update.split(self._sizes), params)])


def is_flat_state(state_dict: Dict) -> bool:
    """Whether an optimizer state_dict is FlatAdam's."""
    return any(g.get("flat", False) for g in state_dict["param_groups"])


def load_optimizer_state(opt: torch.optim.Optimizer, state_dict: Dict
                         ) -> None:
    """opt.load_state_dict, refusing a state of the other layout (per-tensor
    Adam into FlatAdam, or the reverse). The step counts go where `opt`
    keeps them (a state written on the CPU, or before they moved to the
    card, keeps them on the host), and each Adam group keeps `opt`'s
    `capturable`, which load_state_dict would take from the checkpoint.
    Adam's moments take their parameter's memory layout (ops/layout.py),
    which a checkpoint written before 3D weights were channels-last does
    not hold."""
    flat = isinstance(opt, FlatAdam)
    if is_flat_state(state_dict) != flat:
        raise ValueError(
            "the checkpoint's optimizer state was written "
            f"{'without' if flat else 'with'} --flat-opt; resume "
            f"{'without' if flat else 'with'} --flat-opt, as the run was "
            "started")
    capturable = [g.get("capturable", flat) for g in opt.param_groups]
    opt.load_state_dict(state_dict)
    for group, on_device in zip(opt.param_groups, capturable):
        if not flat:
            group["capturable"] = on_device
        for p in group["params"]:
            state = opt.state.get(p, {})
            if "step" in state:
                state["step"] = state["step"].to(
                    p.device if on_device else "cpu", torch.float32)
            for k in ("exp_avg", "exp_avg_sq"):
                if k in state:
                    state[k] = torch.empty_like(p).copy_(state[k])
