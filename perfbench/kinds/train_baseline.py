"""A training cell of the CSG video baseline: one scale of GeneratorCSG
against WDiscriminatorBaselines at the configuration's widths, trained
through the program's own training chunk.

Set-up builds the state that training/baselines_trainer.py::train_scale
builds at the scale: G grown by `init_next_stage` to scale_idx + 1
stages, with weights, the reconstruction's fixed input z_init, the real
clip and the noise amplitudes that the benchmark makes on the card from
the seed; D; G's optimizer over `make_baseline_lr_plan`'s parts, which
clips nothing, and D's; and `TrainChunk` with the baselines' batch former
(`batch_former(3, k, baseline=True)`). The first steps, the window, the
traced chunks, the numbers that decide `correct` (loss, loss1, grad,
step), their limits in the traffic file and the run's record are
kinds/train.py's, whose functions this module uses; the plain reference
is perfbench/reference/csg.py and the FLOP count perfbench/flops/csg.py.
The cell runs on one card.

Under --trace 1 the program's spans (utils/profiling.py) are on from
before the build, so that the captured iteration holds its phases and the
stage inputs' interval ("stage_input", models/networks_3d.py::_Baseline).
The rank's record then holds, over the traced chunks, the median of each
phase's and of the interval's device ms an iteration, and the bytes the
counter "stage_input_bytes" counted an iteration, over the iterations the
chunk ran in Python (eagerly or at its capture; a replay counts nothing).
A program without the interval or the counter leaves them out of the
record, and their metrics read nothing.
"""

from __future__ import annotations

import statistics
import time

from .. import common
from ..flops import csg as flops
from ..reference import csg as ref
from ..reference.hpvaegan import plain_math
from . import train
from .train import (first_steps, gaps, make_amps, make_data, make_weights,
                    passed, program_config, ref_config, seeds, verdict)

INTERVAL, COUNTER = "stage_input", "stage_input_bytes"


def make_z_init(torch, c: dict, seed: int, device):
    """The reconstruction's fixed input, N(0, 1) of (1, nc_im, td0, h0,
    w0), as the baselines trainer draws it."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    shape = (1, c["nc_im"]) + tuple(ref.scale_shape(c, 0))
    return torch.randn(shape, generator=gen, device=device)


def build(torch, c: dict, w: dict, seed: int, device,
          compute_dtype: str = "float32"):
    """The program's training state and chunk, and the inputs both sides
    take."""
    from hpvaegan_tpu_torch import models
    from hpvaegan_tpu_torch.models.blocks import (cfg_compute_dtype,
                                                  set_compute_dtype)
    from hpvaegan_tpu_torch.training.chunk import TrainChunk
    from hpvaegan_tpu_torch.training.partition import make_baseline_lr_plan
    from hpvaegan_tpu_torch.training.state import ScaleTrainState
    from hpvaegan_tpu_torch.training.steps import batch_former
    from hpvaegan_tpu_torch.training.trainer import amps_list, make_optimizers
    from hpvaegan_tpu_torch.utils.noise import NoiseSource

    rc = ref_config(c)
    s = seeds(seed)
    cfg = program_config(c, w, compute_dtype)
    scale = c["scale_idx"]
    inputs = {
        "G": make_weights(torch, ref.generator_spec(rc, scale + 1),
                          s["weights"], device),
        "D": make_weights(torch, ref.discriminator_spec(rc),
                          s["weights"] + (1 << 32), device),
        "z_init": make_z_init(torch, rc, s["weights"] + (2 << 32), device),
        "data": make_data(torch, rc, s["data"], device),
        "amps": make_amps(rc, s["amps"])}
    G = models.get_generator(cfg.generator, 3)(cfg)
    while len(G.body) < scale + 1:
        G.init_next_stage()
    D = models.get_discriminator(cfg.discriminator, 3)(cfg)
    G, D = G.to(device), D.to(device)
    G.load_state_dict(inputs["G"])
    D.load_state_dict(inputs["D"])
    G.z_init = inputs["z_init"]
    for m in (G, D):
        set_compute_dtype(m, cfg_compute_dtype(cfg))
    plan = make_baseline_lr_plan(cfg, scale, len(G.body), has_head=True,
                                 has_tail=True)
    st = ScaleTrainState(G, D, *make_optimizers(cfg, G, D, plan,
                                                float("inf")),
                         NoiseSource(s["noise"], device))
    chunk = TrainChunk(cfg, st, inputs["data"],
                       amps_list(inputs["amps"], cfg.stop_scale), False,
                       batch_former(3, scale, baseline=True))
    return cfg, st, chunk, inputs


def reference_readings(torch, c: dict, w: dict, inputs: dict, seed: int,
                       n: int, device) -> dict:
    rc = ref_config(c)
    with plain_math():
        tr = ref.Trainer(rc, inputs["G"], inputs["D"], inputs["z_init"],
                         inputs["data"], inputs["amps"], w["batch"],
                         seeds(seed)["noise"], device)
        losses, grads = [], {}
        for i in range(n):
            losses.append(tr.iteration())
            if i == 0:
                grads = {f"{part}.{k}": float(g.norm())
                         for part, taken in tr.taken.items()
                         for k, g in taken.items()}
        after = {f"G.{k}": v for k, v in tr.g_train.items()}
        after.update({f"D.{k}": v for k, v in tr.d_train.items()})
    return {"losses": losses, "grads": grads, "after": after}


class _Spans:
    """The program's interval and counter of the traced chunks: the
    phases' and the interval's device ms of each traced chunk's last
    iteration, and the counter's bytes an iteration run in Python."""

    def __init__(self, profiling, chunk):
        self.profiling, self.chunk = profiling, chunk
        self.ran, self.tables = 0, []
        inner = chunk.iteration

        def iteration():
            self.ran += 1
            return inner()
        chunk.iteration = iteration

    def read(self) -> None:
        read = getattr(self.profiling, "interval_ms", None)
        self.tables.append((self.profiling.phase_ms(),
                            read() if read else {}))

    def record(self) -> dict:
        out = {}
        phases = [p for p, _ in self.tables if p]
        if phases:
            out["phases"] = {k: statistics.median(p[k] for p in phases)
                             for k in phases[-1]}
        found = [i[INTERVAL] for _, i in self.tables if INTERVAL in i]
        if found:
            out["intervals"] = {INTERVAL: statistics.median(found)}
        counted = self.profiling.counters().get(COUNTER)
        if counted and self.ran:
            out[COUNTER + "_per_iter"] = counted / self.ran
        return out


def run(torch, ctx: dict) -> dict:
    """One run of the cell on one card; ctx as kinds/train.py's."""
    from hpvaegan_tpu_torch.parallel import mesh
    from hpvaegan_tpu_torch.training import chunk as tchunk
    from hpvaegan_tpu_torch.utils import profiling

    from .. import trace as tr

    cell, args = ctx["cell"], ctx["args"]
    c, w = cell["cfg"], cell["work"]
    if w.get("mesh_data", 1) * w.get("mesh_sp", 1) != 1:
        raise SystemExit("perfbench: the baseline cell runs on one card")
    device = mesh.select_device(ctx.get("device", torch.device("cuda")).type,
                                0)
    if args.trace:
        profiling.reset()
        profiling.enable(True)
    try:
        with mesh.data_parallel(mesh.DataGroup()):
            return _run_cell(torch, ctx, c, w, device, tr, tchunk,
                             profiling)
    finally:
        if args.trace:
            profiling.enable(False)


def _run_cell(torch, ctx, c, w, device, tr, tchunk, profiling):
    args, clock = ctx["args"], ctx["clock"]
    fault = ctx.get("fault")
    imported = clock()
    cfg, st, chunk, inputs = build(torch, c, w, args.seed, device,
                                   ctx.get("compute_dtype", "float32"))
    spans = _Spans(profiling, chunk) if args.trace else None
    if fault is not None:
        fault(st)
    built = clock()
    prog = first_steps(torch, cfg, st, chunk, w["first_steps"])
    spc = tchunk.steps_per_call(cfg)
    setup_s = clock()
    common.note(f"set-up: {imported:.2f} s to the cell, {built - imported:.2f}"
                f" s building, {setup_s - built:.2f} s in the first steps "
                f"(capture {chunk.capture_s:.2f} s); mode {chunk.mode}")
    if ctx.get("readings_only"):
        win = {"iters": 0, "elapsed_s": 0.0, "nonfinite": 0}
    else:
        win = train._window(torch, chunk, spc, args.seconds, 1, device, None)
    summary = None
    if args.trace:
        with tr.traced(torch) as holder:
            for _ in range(w["trace_iterations"] // spc):
                float(chunk.run(spc)["g_loss"])
                spans.read()
        summary = tr.summarize(torch, holder["prof"])
    mine = {"peak": common.peak_bytes(torch, device),
            "capture_s": chunk.capture_s, "pool_bytes": chunk.pool_bytes,
            "trace": summary, "mode": chunk.mode}
    if spans is not None:
        mine.update(spans.record())
        common.note("device ms an iteration: " + ", ".join(
            f"{k} {v:.3f}" for k, v in {**mine.get("phases", {}),
                                        **mine.get("intervals", {})}.items())
            + f"; {COUNTER} an iteration "
            f"{mine.get(COUNTER + '_per_iter')}")
    chunk.close()
    before = {f"G.{k}": inputs["G"][k] for k in st.G.state_dict()
              if f"G.{k}" in prog["after"]}
    before.update({f"D.{k}": inputs["D"][k] for k in st.D.state_dict()
                   if f"D.{k}" in prog["after"]})
    del st, chunk
    if common.on_card(device):
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    refr = reference_readings(torch, c, w, inputs, args.seed,
                              len(prog["losses"]), device)
    common.note(f"the reference's {len(prog['losses'])} iterations: "
                f"{time.perf_counter() - t0:.2f} s")
    values = gaps(prog, refr, before, c["rec_weight"])
    checks = verdict(values, w["limits"])
    rc = ref_config(c)
    name = common.device_name(torch, device)
    peak = common.peak_flops(name, torch.backends.cudnn.allow_tf32)
    bw = common.peak_bandwidth(name)
    roof = flops.iteration(rc, w["batch"], flops.roofline(peak, bw))[
        "total"] if peak and bw else None
    run_ = {"kind": "train", "chips": 1, "iters": win["iters"],
            "elapsed_s": win["elapsed_s"],
            "flops_per_iter": flops.iteration(rc, w["batch"])["total"],
            "peak_flops": peak, "peak_bytes_per_s": bw,
            "roofline_s_per_iter": roof, "ranks": [mine],
            "trace_iters": w["trace_iterations"] // spc * spc}
    metrics = {}
    if ctx.get("readings_only"):
        pass
    elif not args.trace:
        metrics["iters_per_s"] = {"value": win["iters"] / win["elapsed_s"],
                                  "unit": "iters/s"}
        metrics["peak_gb"] = {"value": mine["peak"] / 1e9, "unit": "GB"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    else:
        for m in ctx["cell"]["per_layer"]:
            v = common.reader(m["name"])(run_)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": passed(checks) and win["nonfinite"] == 0,
              "attempted": win["iters"], "failed": win["nonfinite"],
              "metrics": metrics,
              "device": common.device_record(torch, device, 1, mine["peak"])}
    if args.trace:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["readings"] = values  # every number, compared or not
    result["checks"] = checks
    return result
