"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds, for the
tests: the configuration's widths and depth shrunk, its traffic kept."""

from __future__ import annotations

import argparse
import copy

from perfbench import common

TINY = {"nfc": 8, "latent_dim": 4, "num_layer": 2, "enc_blocks": 1,
        "vae_levels": 2, "img_size": 48, "min_size": 16, "max_size": 48,
        "scale_idx": 5, "max_frames": 5, "sampling_rates": [2, 1]}


def cell(name: str, **work) -> dict:
    """The cell `name` at the tiny size, its traffic updated by `work`."""
    c = copy.deepcopy(common.cell(name))
    c["cfg"].update({k: v for k, v in TINY.items()
                     if k in c["cfg"] or k == "scale_idx"})
    c["work"].update(work)
    return c


def run(torch, c: dict, seed: int = 3, seconds: float = 0.0, **ctx) -> dict:
    """One run of cell `c` on the CPU, without the look for a card."""
    args = argparse.Namespace(workload=c["name"], seed=seed,
                              seconds=seconds, trace=0, rank=0, port=0)
    ctx = {"cell": c, "args": args, "clock": common.Clock(),
           "device": torch.device("cpu"), **ctx}
    return common.kind(c["work"]["kind"]).run(torch, ctx)
