"""A sampling cell: a closed loop of one client that asks, back to back,
for `samples` random samples of the generator at the configuration's
finest scale, each request one call of the program's
`evaluation.generate_samples` (per-sample BatchNorm statistics, the eval
default, through parallel/sampling.py::sharded_sampler), ending with the
samples on the host.

Set-up makes the generator's weights and the noise amplitudes on the card
from the seed and warms up with `warmup` requests. Request i draws its
noise from its own NoiseSource, seeded from the seed and i, so that any
request can be made again. The window runs requests until `--seconds`
have passed at a request's end; each request's latency is its call's
host time.

`correct`: `check_requests` of the finished requests, drawn from the seed
by reservoir sampling while the window runs, are made again by the plain
reference (perfbench/reference/hpvaegan.py) after the window, with TF32
off, from the same weights and the same draws. Two numbers: "rms", the
worst request's root-mean-square gap, and "max", the largest absolute
gap of any value, both against the reference's samples in [-1, 1].
"""

from __future__ import annotations

import random
import statistics
import time

import numpy as np

from .. import common
from ..flops import hpvaegan as flops
from ..reference import hpvaegan as ref
from . import train


def request_seed(seed: int, i: int) -> int:
    return (int(seed) * 1000003 + 7919 * (i + 1)) % (1 << 62)


def build(torch, c: dict, w: dict, seed: int, device):
    from hpvaegan_tpu_torch import models

    rc = train.ref_config(c)
    cfg = train.program_config(c, {"batch": 1, "steps_per_call": 1})
    cfg.niter, cfg.num_samples = 1, w["samples"]
    s = train.seeds(seed)
    weights = train.make_weights(torch, ref.generator_spec(rc, c["scale_idx"]),
                                 s["weights"], device)
    amps = train.make_amps(rc, s["amps"])
    cfg.Noise_Amps = amps
    G = models.get_generator(cfg.generator, c["ndim"])(cfg)
    while len(G.body) < c["scale_idx"]:
        G.init_next_stage()
    G = G.to(device)
    G.load_state_dict(weights)
    G.eval()
    return cfg, G, weights, amps


def run(torch, ctx: dict) -> dict:
    from hpvaegan_tpu_torch.evaluation import generate_samples
    from hpvaegan_tpu_torch.parallel import mesh
    from hpvaegan_tpu_torch.utils.noise import NoiseSource

    from .. import trace as tr

    cell, args, clock = ctx["cell"], ctx["args"], ctx["clock"]
    c, w = cell["cfg"], cell["work"]
    device = mesh.select_device(ctx.get("device", torch.device("cuda")).type)
    cfg, G, weights, amps = build(torch, c, w, args.seed, device)

    def request(i: int) -> np.ndarray:
        noise = NoiseSource(request_seed(args.seed, i), device)
        return generate_samples(cfg, G, c["ndim"], train_mode=True,
                                noise=noise)

    if ctx.get("producer") is not None:  # another sampler in its place
        def request(i: int) -> np.ndarray:
            return ctx["producer"](weights, train.ref_config(c), amps,
                                   request_seed(args.seed, i), device,
                                   w["samples"], c["scale_idx"])

    built = clock()
    for i in range(w["warmup"]):
        request(-1 - i)
    setup_s = clock()
    common.note(f"set-up: {built:.2f} s to a built generator, "
                f"{setup_s - built:.2f} s warming up")
    pick = random.Random(args.seed)
    kept, lat = {}, []
    t0 = time.perf_counter()
    i = 0
    while True:
        t = time.perf_counter()
        out = request(i)
        lat.append(time.perf_counter() - t)
        k = w["check_requests"]
        if i < k:
            kept[i] = out
        else:
            j = pick.randrange(i + 1)
            if j < k:
                del kept[sorted(kept)[j]]
                kept[i] = out
        i += 1
        if time.perf_counter() - t0 >= args.seconds:
            break
    elapsed = time.perf_counter() - t0
    summary = None
    if args.trace:
        with tr.traced(torch) as holder:
            for j in range(w["trace_requests"]):
                request(i + j)
        summary = tr.summarize(torch, holder["prof"])
    peak = common.peak_bytes(torch, device)
    del G
    if common.on_card(device):
        torch.cuda.empty_cache()

    rms = mx = 0.0
    with ref.plain_math():
        for r, got in sorted(kept.items()):
            want = ref.sample(weights, train.ref_config(c), w["samples"],
                              amps, request_seed(args.seed, r), device,
                              c["scale_idx"])
            want = want.movedim(1, -1).cpu().numpy()
            diff = got.astype(np.float64) - want
            if not np.isfinite(got).all():
                rms = mx = None
                break
            rms = max(rms, float(np.sqrt(np.mean(diff ** 2))))
            mx = max(mx, float(np.abs(diff).max()))
    values = {"rms": rms, "max": mx}
    checks = train.verdict(values, w["limits"])
    rc = train.ref_config(c)
    name = common.device_name(torch, device)
    top = common.peak_flops(name, torch.backends.cudnn.allow_tf32)
    bw = common.peak_bandwidth(name)
    run_ = {"kind": "sample", "chips": 1, "requests": i,
            "elapsed_s": elapsed, "peak_flops": top,
            "flops_per_request": flops.sample(rc, c["scale_idx"],
                                              w["samples"]),
            "roofline_s_per_request": flops.sample(
                rc, c["scale_idx"], w["samples"], flops.roofline(top, bw))
            if top and bw else None,
            "trace_requests": w["trace_requests"],
            "ranks": [{"trace": summary, "peak": peak}]}
    metrics = {}
    if not args.trace:
        metrics["samples_per_s"] = {
            "value": w["samples"] * i / elapsed, "unit": "samples/s"}
        p95 = statistics.quantiles(lat, n=20, method="inclusive")[18] \
            if len(lat) > 1 else lat[0]
        metrics["sample_p95_ms"] = {"value": 1e3 * p95, "unit": "ms"}
        metrics["peak_gb"] = {"value": peak / 1e9, "unit": "GB"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    else:
        for m in cell["per_layer"]:
            v = common.reader(m["name"])(run_)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": train.passed(checks), "attempted": i, "failed": 0,
              "metrics": metrics,
              "device": common.device_record(torch, device, 1, peak)}
    if args.trace:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["readings"] = values  # every number, compared or not
    result["checks"] = checks
    return result
