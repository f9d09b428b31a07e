"""A training cell: one GAN scale of HP-VAE-GAN at the configuration's
widths, trained through the program's own training chunk.

Set-up builds one training state (G grown to the scale's stages, D, their
optimizers, a NoiseSource) from weights, real data and noise amplitudes
that the benchmark makes on the card from the seed, and hands it to
`training/chunk.py::TrainChunk`, as `training/trainer.py::run_scale`
does. Its first `first_steps` iterations go through `TrainChunk.run(1)`:
the first runs eagerly on the capture stream, the second captures the
iteration as a CUDA graph and replays it, the third replays it. The
window then calls `TrainChunk.run(steps_per_call)` and reads a metric on
the host once a chunk, as the trainer does, until `--seconds` have passed
at a chunk's end; the rate is the iterations over the window's whole
time. The traffic file gives the batch, the chunk and the mesh, and may
pick `scale_idx`; a VAE scale (up to `vae_levels` - 1) trains in the VAE
phase, which the reference does not hold, so such a cell stops with that
message before it runs.

`correct` holds what the first steps produced against the plain
reference (perfbench/reference/hpvaegan.py), run after the window on the
same weights, data and draws with TF32 off, by the numbers that the
traffic file gives a limit, of these:
  loss  each step's D and G loss, the gap over the sum of the
        reference's terms' magnitudes (a loss is a small sum of larger
        terms), the worst of steps and losses;
  loss1 the same of the first step alone, before rounding has moved the
        two sides' weights apart;
  grad  each leaf's first gradient as its optimizer took it, worked out
        from Adam's first moment after step 1 (m / (1 - beta1)): the gap
        of the norms over the reference's norm of that leaf or of its
        module's median leaf, whichever is larger; the worst leaf;
  step  each leaf's change over the first steps, its norm's gap likewise;
        leaves whose reference first gradient is under 1e-3 of their
        module's median are left out (Adam moves them by round-off alone,
        as the conv biases before a BatchNorm).

On the mesh (`mesh_data` x `mesh_sp` ranks, one card each) the process
that run.py starts is rank 0 and starts the others; each rank builds the
same state and runs the same chunks, and rank 0 decides, in one
all-reduce a chunk, when the window ends, gathers the ranks' readings and
runs the reference at the global batch.
"""

from __future__ import annotations

import dataclasses
import math
import os
import statistics
import time
from typing import Dict, List

import numpy as np

from .. import common
from ..flops import hpvaegan as flops
from ..reference import hpvaegan as ref

LOSS_TERMS = {"d_loss": ("d_real", "d_fake", "gp"),
              "g_loss": ("rec", "adv")}


# ------------------------------------------------------------- the inputs

def ref_config(c: dict) -> dict:
    """The configuration as the reference and the FLOP count read it."""
    out = dict(c)
    out["ar"] = c["image_hw"][0] / c["image_hw"][1]
    return out


def make_weights(torch, spec, seed: int, device) -> Dict[str, "torch.Tensor"]:
    """Every tensor of `spec` ((name, shape, law), reference/hpvaegan.py)
    drawn on `device` from `seed`, one draw per law."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out = {}
    for law in ("conv", "gamma", "unit"):
        rows = [(n, s) for n, s, l in spec if l == law]
        flat = torch.randn(sum(math.prod(s) for _, s in rows),
                           generator=gen, device=device)
        for (name, shape), part in zip(rows, flat.split(
                [math.prod(s) for _, s in rows])):
            t = part.reshape(shape)
            if law == "conv":
                t = t * 0.02
            elif law == "gamma":
                t = 1.0 + 0.02 * t
            else:
                t = t / t.norm()
            out[name] = t.contiguous()
    for name, shape, law in spec:
        if law in ("zeros", "ones"):
            out[name] = (torch.zeros if law == "zeros" else torch.ones)(
                shape, device=device)
    return out


def make_amps(c: dict, seed: int) -> List[float]:
    """Scale 0's amplitude 1, then noise_amp times U(0.1, 0.5) for each
    later scale (what a reconstruction's RMSE gives), float32 values."""
    u = np.random.default_rng(int(seed)).uniform(0.1, 0.5,
                                                 c["scale_idx"])
    amps = [1.0] + list(c["noise_amp"] * u)
    return [float(np.float32(a)) for a in amps]


def make_data(torch, c: dict, seed: int, device):
    """The real image (or clip of max_frames frames) at the scale and at
    scale 0, (1, C, [T,] H, W) in [0, 1]."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    frames = (c["max_frames"],) if c["ndim"] == 3 else ()
    hw = ref.pyramid(c)["hw"]
    return [torch.rand((1, c["nc_im"]) + frames + tuple(hw[k]),
                       generator=gen, device=device)
            for k in (c["scale_idx"], 0)]


def seeds(seed: int) -> dict:
    return {"weights": seed, "noise": seed + 1, "data": seed + 2,
            "amps": seed + 3}


# -------------------------------------------------------------- the program

def program_config(c: dict, w: dict, compute_dtype: str = "float32"):
    from hpvaegan_tpu_torch.config import Config
    from hpvaegan_tpu_torch.utils import pyramid

    fields = {f.name for f in dataclasses.fields(Config)}
    kw = {k: v for k, v in c.items() if k in fields and k != "scale_idx"}
    kw.update(batch_size=w["batch"], steps_per_call=w["steps_per_call"],
              mesh_data=w.get("mesh_data", 1), mesh_sp=w.get("mesh_sp", 1),
              compute_dtype=compute_dtype)
    cfg = Config(**kw).finalize()
    cfg.ar = c["image_hw"][0] / c["image_hw"][1]
    cfg.scale_idx = c["scale_idx"]
    if c["ndim"] == 3:
        cfg.org_fps = float(c["org_fps"])
        cfg.fps_lcm = math.lcm(*cfg.sampling_rates)
        cfg.fps, cfg.td, cfg.fps_index = pyramid.get_fps_td_by_index(
            cfg.scale_idx, cfg.stop_scale_time, cfg.sampling_rates,
            cfg.org_fps, cfg.fps_lcm)
    return cfg


def build(torch, c: dict, w: dict, seed: int, device,
          compute_dtype: str = "float32"):
    """The program's training state and chunk, and the inputs both sides
    take."""
    from hpvaegan_tpu_torch import models
    from hpvaegan_tpu_torch.models.blocks import (cfg_compute_dtype,
                                                  set_compute_dtype)
    from hpvaegan_tpu_torch.training.chunk import TrainChunk
    from hpvaegan_tpu_torch.training.partition import make_lr_plan
    from hpvaegan_tpu_torch.training.state import ScaleTrainState
    from hpvaegan_tpu_torch.training.steps import batch_former
    from hpvaegan_tpu_torch.training.trainer import amps_list, make_optimizers
    from hpvaegan_tpu_torch.utils.noise import NoiseSource

    if c["vae_levels"] >= c["scale_idx"] + 1:
        raise SystemExit(f"perfbench: scale {c['scale_idx']} is a VAE scale;"
                         " the reference trains GAN scales only")
    rc = ref_config(c)
    s = seeds(seed)
    cfg = program_config(c, w, compute_dtype)
    ndim, scale = c["ndim"], c["scale_idx"]
    inputs = {
        "G": make_weights(torch, ref.generator_spec(rc, scale),
                          s["weights"], device),
        "D": make_weights(torch, ref.discriminator_spec(rc),
                          s["weights"] + (1 << 32), device),
        "data": make_data(torch, rc, s["data"], device),
        "amps": make_amps(rc, s["amps"])}
    G = models.get_generator(cfg.generator, ndim)(cfg)
    while len(G.body) < scale:
        G.init_next_stage()
    D = models.get_discriminator(cfg.discriminator, ndim)(cfg)
    G, D = G.to(device), D.to(device)
    G.load_state_dict(inputs["G"])
    D.load_state_dict(inputs["D"])
    for m in (G, D):
        set_compute_dtype(m, cfg_compute_dtype(cfg))
    plan = make_lr_plan(cfg, scale, len(G.body))
    st = ScaleTrainState(G, D, *make_optimizers(cfg, G, D, plan,
                                                cfg.grad_clip),
                         NoiseSource(s["noise"], device))
    chunk = TrainChunk(cfg, st, inputs["data"],
                       amps_list(inputs["amps"], cfg.stop_scale), False,
                       batch_former(ndim, scale))
    return cfg, st, chunk, inputs


def _named(module, opt) -> Dict[str, "torch.Tensor"]:
    mine = {id(p) for g in opt.param_groups for p in g["params"]}
    return {k: p for k, p in module.named_parameters() if id(p) in mine}


def first_steps(torch, cfg, st, chunk, n: int) -> dict:
    """Runs the first n iterations through chunk.run(1); returns each
    step's losses, each leaf's first gradient norm as Adam took it, and
    every trained leaf after the n steps."""
    losses, grads = [], {}
    for i in range(n):
        m = chunk.run(1)
        losses.append({k: float(v) for k, v in m.items()})
        if i == 0:
            for part, module, opt in (("G", st.G, st.opt_g),
                                      ("D", st.D, st.opt_d)):
                for k, p in _named(module, opt).items():
                    state = opt.state.get(p, {})
                    if "exp_avg" in state:
                        grads[f"{part}.{k}"] = float(
                            state["exp_avg"].norm() / (1 - cfg.beta1))
    after = {}
    for part, module, opt in (("G", st.G, st.opt_g), ("D", st.D, st.opt_d)):
        for k, p in _named(module, opt).items():
            after[f"{part}.{k}"] = p.detach().clone()
    return {"losses": losses, "grads": grads, "after": after}


# ------------------------------------------------------------ the reference

def reference_readings(torch, c: dict, w: dict, inputs: dict, seed: int,
                       n: int, device) -> dict:
    rc = ref_config(c)
    with ref.plain_math():
        tr = ref.Trainer(rc, inputs["G"], inputs["D"], inputs["data"],
                         inputs["amps"], w["batch"], seeds(seed)["noise"],
                         device)
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


def _module(name: str) -> str:
    return name.split(".", 1)[0]


def gaps(prog: dict, refr: dict, before: dict, rec_weight: float) -> dict:
    """The three numbers of the module's docstring; None where the program
    gave no reading."""
    out = {}
    steps = []
    for p, r in zip(prog["losses"], refr["losses"]):
        worst = 0.0
        for loss, terms in LOSS_TERMS.items():
            scale = sum(abs(r[t]) * (rec_weight if t == "rec" else 1.0)
                        for t in terms)
            if loss not in p or not math.isfinite(p[loss]):
                return dict.fromkeys(("loss", "loss1", "grad", "step"))
            worst = max(worst, abs(p[loss] - r[loss]) / scale)
        steps.append(worst)
    whole = len(prog["losses"]) == len(refr["losses"])
    out["loss"] = max(steps) if whole else None
    out["loss1"] = steps[0] if steps else None

    def by_module(values: Dict[str, float]) -> Dict[str, float]:
        mods = {}
        for k, v in values.items():
            mods.setdefault(_module(k), []).append(v)
        return {m: statistics.median(v) for m, v in mods.items()}

    med = by_module(refr["grads"])
    worst = 0.0
    for k, rn in refr["grads"].items():
        if k not in prog["grads"]:
            worst = None
            break
        worst = max(worst, abs(prog["grads"][k] - rn)
                    / max(rn, med[_module(k)]))
    out["grad"] = worst
    moved = {k for k, rn in refr["grads"].items()
             if rn >= 1e-3 * med[_module(k)]}
    change = {k: float((refr["after"][k] - before[k]).norm()) for k in moved}
    med_change = by_module(change)
    worst = 0.0
    for k in moved:
        if k not in prog["after"]:
            worst = None
            break
        pn = float((prog["after"][k] - before[k]).norm())
        worst = max(worst, abs(pn - change[k])
                    / max(change[k], med_change[_module(k)]))
    out["step"] = worst
    return out


def verdict(values: dict, limits: dict) -> Dict[str, dict]:
    return {k: {"value": values.get(k), "limit": limits[k]} for k in limits}


def passed(checks: Dict[str, dict]) -> bool:
    return all(v["value"] is not None and v["value"] <= v["limit"]
               for v in checks.values())


# --------------------------------------------------------------- the mesh

def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_ranks(ranks: int, argv: List[str]):
    """Starts ranks 1 .. ranks - 1 of this run; returns (port, procs)."""
    import subprocess
    import sys

    port = _free_port()
    os.makedirs(common.CACHE, exist_ok=True)
    procs = []
    for r in range(1, ranks):
        log = open(os.path.join(common.CACHE, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.join(common.HERE, "run.py")] + argv
            + ["--rank", str(r), "--port", str(port)],
            stdout=subprocess.DEVNULL, stderr=log, cwd=common.ROOT), log))
    return port, procs


def watch_ranks(procs) -> None:
    """Ends this run, and the other ranks, as soon as one of them fails:
    this rank would otherwise wait for it in a collective until NCCL's
    timeout."""
    import threading

    def watch():
        while True:
            for p, log in procs:
                if p.poll() not in (None, 0):
                    common.note(f"a rank exited {p.returncode}; see "
                                f"{log.name}")
                    for q, _ in procs:
                        q.kill()
                    os._exit(1)
            if all(p.poll() == 0 for p, _ in procs):
                return
            time.sleep(1.0)

    threading.Thread(target=watch, daemon=True).start()


def die_with_parent() -> None:
    """A started rank ends when the rank that started it does."""
    import ctypes
    import signal

    ctypes.CDLL(None).prctl(1, int(signal.SIGKILL))  # PR_SET_PDEATHSIG
    if os.getppid() == 1:
        os._exit(1)


def join_ranks(procs, timeout: float) -> List[str]:
    """Waits up to `timeout` seconds for the other ranks, ends those still
    running, and returns what went wrong."""
    import subprocess

    errors = []
    deadline = time.monotonic() + timeout
    for i, (p, log) in enumerate(procs):
        try:
            rc = p.wait(max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            rc = p.wait()
        log.close()
        if rc != 0:
            with open(log.name) as f:
                errors.append(f"rank {i + 1} exited {rc}: {f.read()[-2000:]}")
    return errors


# ---------------------------------------------------------------- the cell

def run(torch, ctx: dict) -> dict:
    """One run of the cell; ctx: the cell ("cell"), the parsed arguments
    ("args"), the clock ("clock") and, on the mesh, "rank" and "port"."""
    import torch.distributed as dist

    from hpvaegan_tpu_torch.parallel import mesh, multihost
    from hpvaegan_tpu_torch.training import chunk as tchunk

    from .. import trace as tr

    cell, args, clock = ctx["cell"], ctx["args"], ctx["clock"]
    c, w = cell["cfg"], cell["work"]
    ranks = w.get("mesh_data", 1) * w.get("mesh_sp", 1)
    rank = ctx.get("rank", 0)
    kind = ctx.get("device", torch.device("cuda")).type
    procs = []
    if ranks > 1:
        if rank == 0 and "port" not in ctx:
            port, procs = start_ranks(ranks, ctx["argv"])
            watch_ranks(procs)
        else:
            port = ctx["port"]
            die_with_parent()
        device = mesh.select_device(kind, 0, rank)
        multihost.init_distributed(f"localhost:{port}", ranks, rank,
                                   device=device)
        group = mesh.make_data_group(w["mesh_data"], w["mesh_sp"])
    else:
        device = mesh.select_device(kind, 0)
        group = mesh.DataGroup()
    try:
        with mesh.data_parallel(group):
            out = _run_cell(torch, ctx, c, w, device, ranks, rank, dist, tr,
                            tchunk)
    except BaseException:
        join_ranks(procs, 0)  # the other ranks would wait for this one
        raise
    if ranks > 1:
        dist.destroy_process_group()
    errors = join_ranks(procs, 300)
    if errors:
        raise RuntimeError("; ".join(errors))
    return out


def _window(torch, chunk, spc: int, seconds: float, ranks: int, device,
            dist) -> dict:
    """Chunks until `seconds` have passed at a chunk's end (rank 0's
    clock decides on the mesh); returns iterations, elapsed seconds and
    non-finite metric reads."""
    common.sync(torch, device)
    t0 = time.perf_counter()
    iters = bad = 0
    while True:
        m = chunk.run(spc)
        iters += spc
        bad += not math.isfinite(float(m["g_loss"]))
        done = time.perf_counter() - t0 >= seconds
        if ranks > 1:
            flag = torch.tensor([float(done)], device=device)
            dist.broadcast(flag, 0)
            done = bool(flag.item())
        if done:
            break
    return {"iters": iters, "elapsed_s": time.perf_counter() - t0,
            "nonfinite": bad}


def _run_cell(torch, ctx, c, w, device, ranks, rank, dist, tr, tchunk):
    args, clock = ctx["args"], ctx["clock"]
    fault = ctx.get("fault")
    imported = clock()
    cfg, st, chunk, inputs = build(torch, c, w, args.seed, device,
                                   ctx.get("compute_dtype", "float32"))
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
        win = _window(torch, chunk, spc, args.seconds, ranks, device, dist)
    summary = None
    if args.trace:
        with tr.traced(torch) as holder:
            for _ in range(w["trace_iterations"] // spc):
                float(chunk.run(spc)["g_loss"])
        summary = tr.summarize(torch, holder["prof"])
    mine = {"peak": common.peak_bytes(torch, device),
            "capture_s": chunk.capture_s, "pool_bytes": chunk.pool_bytes,
            "trace": summary, "mode": chunk.mode}
    chunk.close()
    before = {f"G.{k}": inputs["G"][k] for k in st.G.state_dict()
              if f"G.{k}" in prog["after"]}
    before.update({f"D.{k}": inputs["D"][k] for k in st.D.state_dict()
                   if f"D.{k}" in prog["after"]})
    del st, chunk
    if common.on_card(device):
        torch.cuda.empty_cache()
    everyone = [mine]
    if ranks > 1:
        everyone = [None] * ranks
        dist.all_gather_object(everyone, mine)
    if rank != 0:
        return None
    refr = reference_readings(torch, c, w, inputs, args.seed,
                              len(prog["losses"]), device)
    values = gaps(prog, refr, before, c["rec_weight"])
    checks = verdict(values, w["limits"])
    rc = ref_config(c)
    per_iter = flops.iteration(rc, w["batch"])["total"]
    name = common.device_name(torch, device)
    peak = common.peak_flops(name, torch.backends.cudnn.allow_tf32)
    bw = common.peak_bandwidth(name)
    roof = flops.iteration(rc, w["batch"], flops.roofline(peak, bw))[
        "total"] if peak and bw else None
    run_ = {"kind": "train", "chips": ranks, "iters": win["iters"],
            "elapsed_s": win["elapsed_s"], "flops_per_iter": per_iter,
            "peak_flops": peak, "roofline_s_per_iter": roof,
            "ranks": everyone,
            "trace_iters": w["trace_iterations"] // (w["steps_per_call"])
            * w["steps_per_call"]}
    metrics = {}
    if ctx.get("readings_only"):
        pass
    elif not args.trace:
        metrics["iters_per_s"] = {"value": win["iters"] / win["elapsed_s"],
                                  "unit": "iters/s"}
        metrics["peak_gb"] = {"value": max(r["peak"] for r in everyone)
                              / 1e9, "unit": "GB"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    else:
        for m in ctx["cell"]["per_layer"]:
            v = common.reader(m["name"])(run_)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": passed(checks) and win["nonfinite"] == 0,
              "attempted": win["iters"], "failed": win["nonfinite"],
              "metrics": metrics,
              "device": common.device_record(
                  torch, device, ranks, max(r["peak"] for r in everyone))}
    if args.trace:
        result["device"]["busy_s"] = statistics.mean(
            r["trace"]["busy_s"] for r in everyone)
        result["device"]["window_s"] = statistics.mean(
            r["trace"]["window_s"] for r in everyone)
        t0 = everyone[0]["trace"]
        result["breakdown"] = {"device_ops": t0["device_ops"],
                               "idle_gaps": t0["idle_gaps"]}
    result["readings"] = values  # every number, compared or not
    result["checks"] = checks
    return result
