"""The port's CSG video baseline against the benchmark's plain reference
(perfbench/reference/csg.py), on seeded random weights at a tiny size on
the CPU: GeneratorCSG in random and reconstruction mode, the baselines'
critic and its spectral-norm state, three training iterations through
TrainChunk, the benchmark's kind for the cell (perfbench/kinds/
train_baseline.py) sound and with a planted fault, the cell's FLOP count
against torch.utils.flop_counter, and the stage inputs' interval and
byte counter (utils/profiling.py, models/networks_3d.py).

Both sides compute in float32 with the same arithmetic in another order
(F.interpolate's trilinear resize against the port's per-axis gather and
lerp, F.batch_norm against ops/norm.py), so every tolerance below is a
float32 one, set some ten times above the most its reading was seen to
take over seeds 3, 11 and 2**31 + 5.
"""

import copy
import math

import pytest
import torch

from hpvaegan_tpu_torch.models.networks_3d import stage_input_bytes
from hpvaegan_tpu_torch.training.steps import PHASES
from hpvaegan_tpu_torch.utils import profiling
from hpvaegan_tpu_torch.utils.noise import NoiseSource
from perfbench import common
from perfbench.flops import csg as flops
from perfbench.kinds import train, train_baseline
from perfbench.reference import csg as ref
from perfbench.reference.hpvaegan import Draws, scale_shape
from perfbench.tests import faults, tiny
from perfbench.tests.test_flops import ConvFlops

torch.set_num_threads(1)

CPU = torch.device("cpu")
SEED = 2 ** 31 + 5  # over 32 signed bits, as benchmark seeds may be


def _cell(**work):
    """The csg-s9-train cell at the tiny size, 32 px (four scales)."""
    c = tiny.cell("csg-s9-train", steps_per_call=2, **work)
    c["cfg"].update(img_size=32, max_size=32, scale_idx=4)
    return c


def _forward_bytes(c: dict, batch: int) -> int:
    """The stage inputs' least bytes in one forward, from the shapes: at
    each stage from 1 on, the previous output (nfc channels at the scale
    below) read and the input (nfc channels at the scale's size padded by
    num_layer + 1) written, 4 bytes each."""
    rc, p = train.ref_config(c), c["num_layer"] + 1
    return sum(4 * batch * c["nfc"] * (
        math.prod(scale_shape(rc, k - 1))
        + math.prod(s + 2 * p for s in scale_shape(rc, k)))
        for k in range(1, c["scale_idx"] + 1))


@pytest.fixture(scope="module")
def built():
    """The tiny cell's program state and the inputs both sides take."""
    c = _cell()
    cfg, st, chunk, inputs = train_baseline.build(
        torch, c["cfg"], c["work"], SEED, CPU)
    return c, cfg, st, inputs


@pytest.fixture
def spans():
    profiling.enable(False)
    profiling.reset()
    yield profiling
    profiling.enable(False)
    profiling.reset()


def _forward_pair(built, random: bool, batch: int = 2):
    """The program's G and the reference on the same weights and draws."""
    c, cfg, st, inputs = built
    rc = train.ref_config(c["cfg"])
    stages = c["cfg"]["scale_idx"] + 1
    amps = inputs["amps"] + [0.0]
    G = copy.deepcopy(st.G)
    with torch.no_grad():
        if random:
            z = torch.randn((batch, 3) + tuple(scale_shape(rc, 0)),
                            generator=torch.Generator().manual_seed(7))
            mine = G(z, amps, NoiseSource(SEED, CPU), commit=False)[0]
        else:
            z = inputs["z_init"].expand((batch,) + inputs["z_init"].shape[1:])
            mine = G.reconstruct(torch.zeros(batch), amps,
                                 NoiseSource(SEED, CPU), commit=False)[0]
        theirs = ref.generate(inputs["G"], rc, z, amps, Draws(SEED, CPU),
                              stages, random=random)
    return mine, theirs


@pytest.mark.parametrize("random", [True, False],
                         ids=["random", "reconstruction"])
def test_the_generator_matches_the_reference(built, random):
    mine, theirs = _forward_pair(built, random)
    rc = train.ref_config(built[0]["cfg"])
    assert mine.shape == theirs.shape == (2, 3) + tuple(
        scale_shape(rc, built[0]["cfg"]["scale_idx"]))
    # float32 in both (the module docstring); seen up to ~1e-6
    assert (mine - theirs).abs().max() <= 1e-5


def test_the_critic_matches_the_reference(built):
    c, cfg, st, inputs = built
    rc = train.ref_config(c["cfg"])
    x = torch.rand((2, 3) + tuple(scale_shape(rc, c["cfg"]["scale_idx"])),
                   generator=torch.Generator().manual_seed(5)) * 2 - 1
    uv = {n: (inputs["D"][f"{n}.weight_u"], inputs["D"][f"{n}.weight_v"])
          for n in ref.sn_names(inputs["D"])}
    with torch.no_grad():
        scores, state = st.D(x)
        want, new = ref.critic(inputs["D"], uv, rc, x)
    pad = c["cfg"]["num_layer"] + 2
    assert scores.shape == want.shape == (2, 1) + tuple(
        s + 2 * pad for s in x.shape[2:])
    # float32 convolutions of the same sums; seen ~1e-8
    assert (scores - want).abs().max() <= 1e-6
    assert len(state) == len(new) == c["cfg"]["num_layer"]
    for (u, v), (u_ref, v_ref) in zip(state, new.values()):
        # one power step of a matrix-vector product; seen ~1e-8
        assert (u - u_ref).abs().max() <= 1e-6
        assert (v - v_ref).abs().max() <= 1e-6


@pytest.fixture(scope="module")
def sound_run():
    return tiny.run(torch, _cell(), seed=SEED, seconds=0.0)


def test_three_iterations_match_the_reference(sound_run):
    """The gaps kinds/train.py defines, of the first three iterations
    through TrainChunk against the reference's Trainer."""
    got = sound_run["readings"]
    # the losses: terms of ~1e-3 to 1 in float32; seen up to 1.2e-7
    assert got["loss1"] <= 1e-6 and got["loss"] <= 1e-6
    # the first gradients: BatchNorm's backward cancels most of its input,
    # which leaves a few float32 ulps of a leaf's norm; seen up to 1.3e-6
    assert got["grad"] <= 1e-5
    # Adam's steps divide by the root of the second moment, which brings a
    # small gradient's rounding up to a step's size; seen up to 5e-6
    assert got["step"] <= 5e-5


def test_the_kind_reads_correct(sound_run):
    assert sound_run["correct"] is True, sound_run["checks"]
    assert set(sound_run["metrics"]) == {"iters_per_s", "peak_gb", "setup_s"}
    assert sound_run["attempted"] == 2 and sound_run["failed"] == 0


def test_a_frozen_step_reads_not_correct():
    ctx = {}
    faults.plant("frozen", ctx)
    result = tiny.run(torch, _cell(), seed=SEED, seconds=0.0, **ctx)
    assert result["correct"] is False
    assert result["readings"]["step"] == pytest.approx(1.0)


def test_the_flop_count():
    """flops/csg.py's iteration, plus the critic's double-backward
    convolutions that autograd also runs (flops.autograd_extra), is what
    PyTorch's formulas count of one iteration."""
    c = _cell()
    cfg, st, chunk, _ = train_baseline.build(torch, c["cfg"], c["work"], 5,
                                             CPU)
    chunk.run(1)  # the optimizers' state, made lazily
    with ConvFlops() as counted:
        chunk.run(1)
    rc = train.ref_config(c["cfg"])
    want = flops.iteration(rc, 1)
    assert counted.total == want["total"] + flops.autograd_extra(rc, 1)
    assert want["d_step"] > want["g_step"] > 0
    inf = math.inf
    assert flops.iteration(rc, 1, flops.roofline(2.0, inf))["total"] \
        == want["total"] / 2.0


def test_the_stage_inputs_interval_and_bytes(built, spans, monkeypatch):
    """On, every stage from 1 on records one "stage_input" interval a
    forward, and the counter adds the previous output's and the padded
    input's bytes, from the shapes alone; off, neither records."""
    c = built[0]
    stages, batch = c["cfg"]["scale_idx"] + 1, 2
    want = _forward_bytes(c["cfg"], batch)
    marks = []
    inner = profiling._mark

    def mark(device):
        marks.append(device)
        return inner(device)

    monkeypatch.setattr(profiling, "_mark", mark)
    for random in (True, False):
        _forward_pair(built, random, batch)
    assert marks == [] and spans.counters() == {} and spans.totals() == {}
    spans.enable(True)
    for i, random in enumerate((True, False)):
        with spans.phases(CPU):
            with spans.phase("forward"):
                _forward_pair(built, random, batch)
        # a padded stage input has the same shape in either mode
        assert spans.counters()["stage_input_bytes"] == want * (i + 1)
        assert spans.interval_ms()["stage_input"] > 0
    # each forward: the phase's two boundaries, two marks an interval
    assert len(marks) == 2 * (2 + 2 * (stages - 1))
    # the totals count an eager block's intervals of a name once
    assert spans.totals()["stage_input"][0] == 2
    # the bytes follow each tensor's dtype (bfloat16 under --compute-dtype)
    x = torch.zeros(batch, 8, 2, 3, 4)
    assert stage_input_bytes(x, x.bfloat16()) == 6 * x.numel()


def test_the_kind_reads_the_spans_an_iteration(spans):
    """The kind's record under --trace 1 (without the device trace): the
    phases and the interval of the last iteration, and the counter's bytes
    an iteration, three forwards' (the D step's fake, the reconstruction,
    the G step's fake); and the metrics that read them."""
    c = _cell()
    spans.enable(True)
    _, _, chunk, _ = train_baseline.build(torch, c["cfg"], c["work"], SEED,
                                          CPU)
    record = train_baseline._Spans(profiling, chunk)
    for _ in range(2):
        chunk.run(2)
        record.read()
    mine = record.record()
    forward = _forward_bytes(c["cfg"], 1)
    assert record.ran == 4
    assert mine["stage_input_bytes_per_iter"] == 3 * forward
    assert list(mine["phases"]) == list(PHASES)
    assert 0 < mine["intervals"]["stage_input"] < sum(mine["phases"].values())
    run = {"kind": "train", "peak_bytes_per_s": 1e9, "ranks": [mine]}
    share = common.reader("stage_input_pct.train")(run)
    assert share == pytest.approx(100 * mine["intervals"]["stage_input"]
                                  / sum(mine["phases"].values()))
    assert common.reader("stage_input_roofline_pct.train")(run) == \
        pytest.approx(100 * 3 * forward / 1e9
                      / (mine["intervals"]["stage_input"] / 1e3))
    # a program without the interval and the counter (the parent's)
    bare = {"kind": "train", "peak_bytes_per_s": 1e9,
            "ranks": [{"phases": mine["phases"]}]}
    for metric in ("stage_input_pct.train", "stage_input_roofline_pct.train"):
        assert common.reader(metric)(bare) is None
        assert common.reader(metric)({"kind": "sample"}) is None
