"""The program's own spans and counters (utils/profiling.py) on the CPU:
host spans, the training iteration's phases, the collectives counted by
kind and bytes where parallel/mesh.py and spatial.py issue them, and the
sampler's copy to the host.

The two-rank cases run this file as a script (test_torch_multihost.py::
run_ranks).
"""

import os
import sys
import time

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(HERE))

from hpvaegan_tpu_torch.config import Config  # noqa: E402
from hpvaegan_tpu_torch.parallel import mesh  # noqa: E402
from hpvaegan_tpu_torch.training.steps import PHASES  # noqa: E402
from hpvaegan_tpu_torch.utils import profiling  # noqa: E402

from test_torch_multihost import run_ranks, worker_main  # noqa: E402

torch.set_num_threads(1)

GAN = list(PHASES)
VAE = ["batch", "g.forward", "g.backward", "g.exchange", "g.optim",
       "metrics"]


@pytest.fixture(autouse=True)
def fresh():
    profiling.enable(False)
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        fn()
    return [e for e in prof.events() if e.name == "unit.span"]


def _span():
    with profiling.span("unit.span", request=7):
        torch.ones(4).add_(1)


def test_a_span_off_is_a_shared_no_op():
    assert not profiling.enabled()
    assert profiling.span("a") is profiling.span("b")
    assert profiling.phase("a") is profiling.phases("cpu")
    _span()
    profiling.count("bytes", 10)
    assert profiling.totals() == {} and profiling.counters() == {}


def test_a_span_on_is_a_profiler_event_and_a_total():
    """Under a profiler the span is its event, with the request attribute
    (shown where the profiler records shapes), and a total; turned on
    without a profiler, a total alone."""
    events = _profiled(_span)
    assert len(events) == 1 and events[0].kwinputs == {"request": 7}
    assert profiling.totals()["unit.span"][0] == 1
    profiling.enable(True)
    _span()
    assert profiling.totals()["unit.span"][0] == 2
    profiling.count("bytes", 10)
    profiling.count("bytes", 5)
    assert profiling.counters() == {"bytes": 15}
    profiling.reset()
    assert profiling.totals() == {} and profiling.counters() == {}


def test_trace_turns_the_spans_on_for_its_block_only(tmp_path):
    with profiling.trace(str(tmp_path), "cpu"):
        assert profiling.enabled()
        _span()
    assert not profiling.enabled()
    with open(tmp_path / profiling.TRACE_NAME) as f:
        assert '"unit.span"' in f.read()
    with profiling.trace("", "cpu"):
        assert not profiling.enabled()


def test_phases_share_their_boundaries_and_do_not_nest():
    profiling.enable(True)
    with profiling.phases("cpu"):
        with profiling.phase("d.forward"):
            time.sleep(0.002)
        with profiling.phase(".backward"):
            time.sleep(0.002)
        with pytest.raises(RuntimeError, match="do not nest"):
            with profiling.phase("a"):
                with profiling.phase("b"):
                    pass
    seq = profiling.last_phases()
    assert seq.names[:2] == ["d.forward", "d.backward"]
    assert len(seq.marks) == len(seq.names) + 1
    with profiling.phase("lone", "cpu"):
        time.sleep(0.002)
    assert profiling.last_phases() is seq  # a lone phase is no block
    assert profiling.totals()["lone"][1] >= 0.002
    # outside a block, without a device (its block began while the spans
    # were off): nothing
    assert profiling.phase("inner") is profiling.phase("other")
    with profiling.phase("inner"):
        pass
    assert "inner" not in profiling.totals()


def test_intervals_lie_inside_phases_without_tiling():
    """An interval is its own pair of marks inside a phase, summed by name
    into its block's interval_ms() and left out of its phases; outside a
    block it is a total; off, the shared no-op."""
    assert profiling.interval("a", "cpu") is profiling.span("b")
    profiling.enable(True)
    with profiling.phases("cpu"):
        with profiling.phase("g.forward"):
            for _ in range(2):
                with profiling.interval("stage_input", torch.zeros(1)):
                    time.sleep(0.002)
        with profiling.phase(".optim"):
            pass
    assert list(profiling.phase_ms()) == ["g.forward", "g.optim"]
    ms = profiling.interval_ms()
    assert list(ms) == ["stage_input"]
    assert 4.0 <= ms["stage_input"] <= profiling.phase_ms()["g.forward"]
    assert len(profiling.last_phases().intervals) == 2
    with profiling.interval("lone", "cpu"):
        time.sleep(0.002)
    assert profiling.interval_ms() == ms  # a lone interval is no block
    assert profiling.totals()["lone"][1] >= 0.002
    assert profiling.totals()["stage_input"][1] >= 0.004


def _tiny(**kw):
    from hpvaegan_tpu_torch.tools.step_parity import build_state
    from hpvaegan_tpu_torch.utils.noise import NoiseSource
    from hpvaegan_tpu_torch.utils.pyramid import scale_size_2d

    cfg = Config(nfc=8, num_layer=2, img_size=32, min_size=16, max_size=32,
                 latent_dim=8, enc_blocks=1, vae_levels=2, **kw).finalize()
    cfg.scale_idx, cfg.ar = 3, 0.75
    st = build_state(cfg, 3, 0, "cpu")
    st.noise = NoiseSource(0, "cpu")
    gen = torch.Generator().manual_seed(1)
    data = [torch.rand((1, 3) + tuple(scale_size_2d(
        k, cfg.scale_factor, cfg.stop_scale, cfg.img_size, cfg.ar)),
        generator=gen) for k in (3, 0)]
    return cfg, st, data, [1.0] + [0.05] * (cfg.stop_scale + 1)


@pytest.mark.parametrize("case,want", [
    ({}, GAN), ({"vae_phase": True}, VAE), ({"fused_dg": True}, GAN)])
def test_an_iteration_is_tiled_by_its_phases(case, want):
    """The iteration's phases, in order, share their boundaries, and their
    sum is the iteration's time (host-timed on the CPU); off, none."""
    from hpvaegan_tpu_torch.training.steps import batch_former, \
        train_iteration

    vae = case.pop("vae_phase", False)
    cfg, st, data, amps = _tiny(**case)

    def iteration():
        return train_iteration(cfg, st, data[0], data[1], amps, vae,
                               batch_former(2, 3))

    iteration()
    assert profiling.last_phases() is None
    profiling.enable(True)
    t0 = time.perf_counter()
    iteration()
    wall = 1e3 * (time.perf_counter() - t0)
    seq = profiling.last_phases()
    assert seq.names == want
    assert len(seq.marks) == len(want) + 1
    got = profiling.phase_ms()
    assert list(got) == want and all(v >= 0 for v in got.values())
    assert 0.9 * wall <= sum(got.values()) <= wall


def test_a_chunk_reports_its_last_iteration():
    from hpvaegan_tpu_torch.training.chunk import TrainChunk
    from hpvaegan_tpu_torch.training.steps import batch_former

    cfg, st, data, amps = _tiny()
    chunk = TrainChunk(cfg, st, data, amps, False, batch_former(2, 3))
    chunk.run(1)
    assert chunk.phase_ms() == {}
    assert chunk.collectives_per_iter == {k: [0, 0] for k in mesh.KINDS}
    profiling.enable(True)
    chunk.run(2)
    assert list(chunk.phase_ms()) == GAN
    assert chunk.phase_ms() == profiling.phase_ms()


def test_generate_samples_counts_its_bytes_to_the_host():
    from hpvaegan_tpu_torch.evaluation import generate_samples
    from hpvaegan_tpu_torch.models import get_generator

    cfg = Config(nfc=8, num_layer=2, img_size=32, min_size=16, max_size=32,
                 latent_dim=8, enc_blocks=1, vae_levels=2).finalize()
    cfg.ar, cfg.niter, cfg.num_samples = 0.75, 1, 3
    cfg.Noise_Amps = [1.0, 0.05, 0.05, 0.05]
    G = get_generator(cfg.generator)(cfg)
    while len(G.body) < 3:
        G.init_next_stage()
    G.eval()
    profiling.enable(True)
    for _ in range(2):
        out = generate_samples(cfg, G, 2, seed=1)
    n, h, w, c = out.shape
    assert profiling.counters() == {"d2h_bytes": 2 * 4 * n * h * w * c}
    found = profiling.totals()
    for name in ("sample.forward", "sample.to_host", "sample.assemble",
                 "d2h"):
        assert found[name][0] == 2, name


# ------------------------------------------------------ two gloo ranks ---

def _spied():
    """Wraps torch.distributed's all_reduce and all_gather to count, apart
    from the program's counters, each call and the bytes of the rank's
    buffer by kind: a mean_ call is "grad" under _set_grads, else
    "metric"; an all-gather is "halo"; any other all-reduce is "halo" for
    an activation (3 dimensions or more: the spatial sums) and "bn" for
    BatchNorm's per-channel sums."""
    import torch.distributed as dist

    seen = {k: [0, 0] for k in mesh.KINDS}
    reduce, gather = dist.all_reduce, dist.all_gather

    def callers():
        f, names = sys._getframe(2), set()
        while f is not None:
            names.add(f.f_code.co_name)
            f = f.f_back
        return names

    def note(kind, t):
        seen[kind][0] += 1
        seen[kind][1] += t.numel() * t.element_size()

    def all_reduce(t, *a, **k):
        names = callers()
        if "mean_" in names:
            kind = "grad" if "_set_grads" in names else "metric"
        else:
            kind = "halo" if t.dim() >= 3 else "bn"
        note(kind, t)
        return reduce(t, *a, **k)

    def all_gather(parts, t, *a, **k):
        note("halo", t)
        return gather(parts, t, *a, **k)

    dist.all_reduce, dist.all_gather = all_reduce, all_gather
    return seen


def _case_counts(rank, world, out_dir, data, sp):
    from hpvaegan_tpu_torch.training.steps import batch_former, \
        train_iteration

    data, sp = int(data), int(sp)
    cfg, st, images, amps = _tiny(batch_size=2, mesh_data=data, mesh_sp=sp)
    with mesh.data_parallel(mesh.make_data_group(data, sp)):
        seen = _spied()
        before = mesh.collectives()
        metrics = train_iteration(cfg, st, images[0], images[1], amps, False,
                                  batch_former(2, 3))
    counted = {k: [a - b for a, b in zip(v, before[k])]
               for k, v in mesh.collectives().items()}
    trained = sum(p.numel() for p in st.D.parameters()) + sum(
        p.numel() for g in st.opt_g.param_groups for p in g["params"])
    return {"counted": counted, "seen": seen, "trained": trained,
            "metrics": len(metrics)}


@pytest.mark.parametrize("data,sp", [(2, 1), (1, 2)])
def test_collectives_are_counted_by_kind_and_bytes(tmp_path, data, sp):
    """One iteration on two gloo ranks: the program's counts equal, kind by
    kind, the calls and bytes seen at torch.distributed; the gradients'
    are two (D, G) of 4 bytes a trained element, the metrics' one."""
    for out in run_ranks(__file__, "counts", tmp_path, data, sp):
        counted, seen = out["counted"], out["seen"]
        assert counted == seen
        assert counted["grad"] == [2, 4 * out["trained"]]
        assert counted["metric"] == [1, 4 * out["metrics"]]
        assert counted["bn"][0] > 0
        assert (counted["halo"][0] > 0) is (sp > 1)


if __name__ == "__main__":
    worker_main({"counts": _case_counts})
