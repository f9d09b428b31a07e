"""Faults planted in the program under the harness, each of which a run
must report as not correct: the step that leaves its state unchanged,
half of the batch left out (each data rank keeps its own gradients, so
rank 0 trains on its half alone), the halo exchange between cards left
out (zeros for the neighbours' rows), BatchNorm's group sums left out
(each rank normalises by the statistics of its own rows alone), and a
sample altered where the sampler produces it (one sample replaced by
another)."""

from __future__ import annotations


def plant(fault: str, ctx: dict) -> None:
    """Plants `fault` in this process; training faults that act on the
    built state go into ctx["fault"]."""
    if fault == "frozen":
        def freeze(st):
            st.opt_g.step = lambda *a, **k: None
            st.opt_d.step = lambda *a, **k: None
        ctx["fault"] = freeze
    elif fault == "half_batch":
        import torch

        from hpvaegan_tpu_torch.training import steps

        def set_grads(params, loss):
            grads = torch.autograd.grad(loss, params, materialize_grads=True)
            for p, g in zip(params, grads):
                p.grad = g
        steps._set_grads = set_grads
    elif fault == "no_exchange":
        import torch

        from hpvaegan_tpu_torch.parallel import spatial

        spatial._neighbour_rows = lambda top, bottom, ax: (
            torch.zeros_like(bottom), torch.zeros_like(top))
    elif fault == "no_bn_sums":
        from hpvaegan_tpu_torch.ops import norm

        inner = norm._group_batch_stats

        def local(xf, groups, group_sum, n):
            return inner(xf, groups, lambda t: t,
                         xf.numel() // (groups * xf.shape[1]))
        norm._group_batch_stats = local
    elif fault == "altered_sample":
        from hpvaegan_tpu_torch.parallel import sampling

        inner = sampling._host_copy

        def altered(t):
            out = inner(t)
            out[0] = out[-1]
            return out
        sampling._host_copy = altered
    else:
        raise ValueError(f"unknown fault {fault!r}")
