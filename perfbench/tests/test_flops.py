"""perfbench/flops against PyTorch's own FLOP formulas
(torch.utils.flop_counter) for one eager training iteration and one
sampler call of the program, in 2D and 3D, at a tiny size on the CPU."""


import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from perfbench.flops import hpvaegan as flops
from perfbench.kinds import sample, train
from perfbench.tests import tiny


class ConvFlops(TorchDispatchMode):
    """The convolution FLOPs of the ops run in the body, by the formulas
    FlopCounterMode uses. FlopCounterMode itself cannot count the
    iteration: its module hooks refuse the gradient penalty's
    torch.autograd.grad on a leaf."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry and "convolution" in str(packet):
            def shape(t):
                return t.shape if isinstance(t, torch.Tensor) else t
            self.total += flop_registry[packet](
                *tree_map(shape, args), **tree_map(shape, kwargs),
                out_val=tree_map(shape, out))
        return out


@pytest.mark.parametrize("name", ["img-s9-train", "vid-s9-train",
                                  "img-s9-train-dp2sp2"])
def test_iteration_flops(name):
    cell = tiny.cell(name)
    c, w = cell["cfg"], cell["work"]
    # the mesh's global batch, in one process
    w = dict(w, mesh_data=1, mesh_sp=1)
    cfg, st, chunk, _ = train.build(torch, c, w, 5, torch.device("cpu"))
    chunk.run(1)  # the optimizers' state, made lazily
    with ConvFlops() as counted:
        chunk.run(1)
    rc = train.ref_config(c)
    want = flops.iteration(rc, w["batch"])
    assert counted.total == want["total"] + flops.autograd_extra(
        rc, w["batch"])
    assert want["d_step"] > want["g_step"] > 0


@pytest.mark.parametrize("name", ["hpvaegan-image", "hpvaegan-video"])
def test_sampler_flops(name):
    from hpvaegan_tpu_torch.evaluation import generate_samples
    from hpvaegan_tpu_torch.utils.noise import NoiseSource

    cell = tiny.cell("img-sample64", samples=3)
    if name == "hpvaegan-video":
        video = tiny.cell("vid-s9-train")["cfg"]
        cell["cfg"] = video
    c = cell["cfg"]
    cfg, G, _, _ = sample.build(torch, c, cell["work"], 5,
                                torch.device("cpu"))
    if c["ndim"] == 3:
        cfg.td = None  # the eval scale's time depth, from cfg.scale_idx
    with FlopCounterMode(display=False) as counter:
        generate_samples(cfg, G, c["ndim"], noise=NoiseSource(1, "cpu"))
    counts = counter.get_flop_counts()["Global"]
    conv = sum(v for k, v in counts.items() if "convolution" in str(k))
    assert conv == flops.sample(train.ref_config(c), c["scale_idx"], 3)


class ConvBytes(TorchDispatchMode):
    """The bytes of the input, the weights and the output of each forward
    convolution run in the body."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func._overloadpacket is torch.ops.aten.convolution:
            self.total += sum(t.numel() * t.element_size()
                              for t in (args[0], args[1], out))
        return out


@pytest.mark.parametrize("name", ["hpvaegan-image", "hpvaegan-video"])
def test_sampler_roofline(name):
    """The roofline cost with an unbounded bandwidth is the FLOPs over the
    peak, and with an unbounded peak the bytes the forward convolutions
    read and write over the bandwidth."""
    from hpvaegan_tpu_torch.evaluation import generate_samples
    from hpvaegan_tpu_torch.utils.noise import NoiseSource

    cell = tiny.cell("img-sample64", samples=3)
    if name == "hpvaegan-video":
        cell["cfg"] = tiny.cell("vid-s9-train")["cfg"]
    c = cell["cfg"]
    cfg, G, _, _ = sample.build(torch, c, cell["work"], 5,
                                torch.device("cpu"))
    if c["ndim"] == 3:
        cfg.td = None
    with ConvBytes() as counted:
        generate_samples(cfg, G, c["ndim"], noise=NoiseSource(1, "cpu"))
    rc, stages, inf = train.ref_config(c), c["scale_idx"], float("inf")
    assert flops.sample(rc, stages, 3, flops.roofline(2.0, inf)) == \
        flops.sample(rc, stages, 3) / 2.0
    assert flops.sample(rc, stages, 3, flops.roofline(inf, 4.0)) == \
        counted.total / 4.0
