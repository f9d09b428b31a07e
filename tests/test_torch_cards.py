"""The port on NCCL ranks, one card each: what only NCCL, CUDA graphs and
K1 make of the mesh (parallel/mesh.py, parallel/spatial.py). Tiny widths,
TF32 off and deterministic cuDNN. Each case needs as many cards as it has
ranks and skips on fewer; on one card only the one-rank cases run. The
module imports neither JAX nor the JAX package, so it also runs where JAX
is not installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cards.py

The ranks run this file as a script, one process per rank
(torch_ranks.py::run_ranks); the CLI case runs it under torchrun.
"""

import glob
import hashlib
import json
import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
if __name__ == "__main__":
    sys.path.insert(0, REPO)

from torch_card_helpers import (TINY, chunk_state, flag_cfg,  # noqa: E402
                                make_chunk)
from torch_ranks import run_ranks, worker_main  # noqa: E402

pytestmark = pytest.mark.cuda


def _cards(n):
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} NVIDIA card(s)")


def _exact_math():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True


def _join(fn, rank, world):
    """This rank's card, made current, in an NCCL group of `world` ranks,
    with TF32 off and deterministic cuDNN."""
    import torch.distributed as dist

    from hpvaegan_tpu_torch.parallel import mesh, multihost

    _exact_math()
    device = mesh.select_device("cuda", 0, rank)
    multihost.init_distributed(f"127.0.0.1:{fn.port}", world, rank,
                               device=device)
    assert dist.get_backend() == "nccl"
    return device


def _group(world, mesh_data=None, mesh_sp=1):
    """The group the cases run in: the mesh of `mesh_data` x `mesh_sp`
    ranks, or one rank's group, which runs its collectives as a mesh
    does."""
    import torch.distributed as dist

    from hpvaegan_tpu_torch.parallel import mesh

    if world == 1:
        return mesh.DataGroup(0, 1, dist.group.WORLD)
    return mesh.make_data_group(mesh_data or world, mesh_sp)


def _collective_calls(mesh) -> int:
    """The collectives issued so far, summed over their kinds."""
    return sum(calls for calls, _ in mesh.collectives().values())


def _digest(module):
    h = hashlib.sha1()
    for k, v in sorted(module.state_dict().items()):
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


# ------------------------------------------------- the training chunk ---

def _case_chunk(rank, world, out_dir, ndim, generator, mesh_data, mesh_sp):
    """test_graph_chunk_in_an_nccl_group_equals_eager on this rank."""
    from hpvaegan_tpu_torch.parallel import mesh

    device = _join(_case_chunk, rank, world)
    ndim, mesh_data, mesh_sp = int(ndim), int(mesh_data), int(mesh_sp)
    cfg = flag_cfg(ndim, generator, batch_size=2)
    disc = cfg.discriminator if generator == "GeneratorCSG" else ""
    with mesh.data_parallel(_group(world, mesh_data, mesh_sp)):
        graph_st, graph = make_chunk(cfg, ndim, False, device, generator, disc)
        eager_st, eager = make_chunk(cfg, ndim, True, device, generator, disc)
        graph.run(3)
        calls = _collective_calls(mesh)
        got = graph.run(4)
        captured = _collective_calls(mesh) - calls
        for _ in range(7):
            calls = _collective_calls(mesh)
            want = eager.run(1)
        per_iteration = _collective_calls(mesh) - calls
        torch.cuda.synchronize()
    a, b = chunk_state(graph_st), chunk_state(eager_st)
    out = {"modes": (graph.mode, eager.mode), "captured": captured,
           "per_iteration": per_iteration,
           "collectives_per_iter": (graph.collectives_per_iter,
                                    eager.collectives_per_iter),
           "metrics_differ": [k for k in want
                              if not torch.equal(got[k], want[k])],
           "keys_equal": sorted(a) == sorted(b),
           "state_differ": [k for k in a
                            if not torch.equal(a[k].cpu(), b[k].cpu())],
           "G": _digest(graph_st.G), "D": _digest(graph_st.D)}
    graph.close()
    return out


_case_chunk.joins_itself = True


@pytest.mark.parametrize("ranks,ndim,generator,mesh_data,mesh_sp", [
    (1, 2, "GeneratorHPVAEGAN", 1, 1),
    (1, 3, "GeneratorHPVAEGAN", 1, 1),
    (4, 2, "GeneratorHPVAEGAN", 2, 2),
    (4, 3, "GeneratorHPVAEGAN", 2, 2),
    (4, 3, "GeneratorCSG", 1, 4)],
    ids=["1-2d", "1-3d", "4-2d-dp2sp2", "4-3d-dp2sp2", "4-csg-sp4"])
def test_graph_chunk_in_an_nccl_group_equals_eager(tmp_path, ranks, ndim,
                                                   generator, mesh_data,
                                                   mesh_sp):
    """In an NCCL group the chunk is a graph whose capture holds the
    group's collectives (mean_'s all-reduce of the gradients and metrics,
    BatchNorm's group sums, the halo exchanges of H split over
    --mesh-sp): chunks of 3 and 4 iterations end bit for bit as 7
    --split-step eager iterations in the same group, and the capture
    issues as many collectives as one eager iteration; the ranks' G and D
    are bit-equal. One rank; then --mesh-data 2 --mesh-sp 2 in 2D and 3D,
    and GeneratorCSG on --mesh-sp 4, whose padded stages' edge ranks hold
    more rows than the middle ranks."""
    _cards(ranks)
    outs = run_ranks(__file__, "chunk", tmp_path, ndim, generator,
                     mesh_data, mesh_sp, world=ranks, timeout=600)
    mode = f"graph ({ranks} NCCL rank{'' if ranks == 1 else 's'})"
    for out in outs:
        assert out["modes"] == (mode, "eager (split-step)")
        assert out["captured"] == out["per_iteration"] > 0, out
        assert out["collectives_per_iter"][0] == \
            out["collectives_per_iter"][1]
        assert out["metrics_differ"] == [] and out["keys_equal"]
        assert out["state_differ"] == []
    assert len({(out["G"], out["D"]) for out in outs}) == 1


# ------------------------------------------------------------ sampling ---

def _case_sampling(rank, world, out_dir):
    """test_sharded_sampling_in_an_nccl_group_equals_one_process on this
    rank."""
    from hpvaegan_tpu_torch.config import Config
    from hpvaegan_tpu_torch.evaluation import eval_z_tail
    from hpvaegan_tpu_torch.models.networks_2d import GeneratorHPVAEGAN
    from hpvaegan_tpu_torch.models.networks_3d import (
        GeneratorHPVAEGAN as GeneratorHPVAEGAN3D)
    from hpvaegan_tpu_torch.ops import fused_upscale_noise as k1
    from hpvaegan_tpu_torch.parallel import mesh, multihost, sampling
    from hpvaegan_tpu_torch.utils.noise import NoiseSource

    device = _join(_case_sampling, rank, world)
    out = {"agree": (multihost.agree_float(rank + 2.5),
                     multihost.agree_seed(rank + 7),
                     multihost.agree_minmax(rank + 0.5),
                     multihost.broadcast_str(f"rank {rank}")),
           "gathered": multihost.to_host((
               torch.full((2, 3), float(rank), device=device),
               torch.full((1,), rank, device=device)))}
    try:
        multihost.broadcast_str("x" * 5000 if rank == 0 else "")
        out["long_raised"] = False
    except ValueError:
        out["long_raised"] = True

    cfg = Config(nfc=8, latent_dim=8, num_layer=2, img_size=32, min_size=16,
                 max_size=32, niter=2, pallas_fused_sampling=True).finalize()
    cfg.Noise_Amps = [1.0] + [0.1] * cfg.stop_scale
    gen = GeneratorHPVAEGAN(cfg)
    vcfg = flag_cfg(3)
    vcfg.Noise_Amps = [1.0] + [0.3] * vcfg.stop_scale
    vcfg.scale_idx, vcfg.td = vcfg.stop_scale, 3
    vgen = GeneratorHPVAEGAN3D(vcfg)
    for g, c in ((gen, cfg), (vgen, vcfg)):
        for _ in range(c.stop_scale):
            g.init_next_stage(torch.Generator().manual_seed(0))
    gen, vgen = gen.to(device), vgen.to(device)
    rng = np.random.RandomState(1)
    real = rng.rand(20, 26, 3).astype(np.float32)
    clip = rng.rand(5, 20, 26, 3).astype(np.float32)
    n = 8

    def run():
        sample = sampling.sharded_sampler(cfg, gen, train=False)
        k1.fused_upscale_noise_2d.launches = 0
        rows = sample(n, NoiseSource(1, device))
        launches = k1.fused_upscale_noise_2d.launches
        sifid = sampling.make_sampled_sifid(cfg, gen, real)(
            n, NoiseSource(2, device))
        svfid = sampling.make_sampled_svfid(
            vcfg, vgen, clip, z_tail=eval_z_tail(vcfg, 3))(
                n, NoiseSource(3, device))
        return rows, launches, sifid, svfid

    one = run()
    with mesh.data_parallel(_group(world)):
        rows, out["launches"], out["sifid"], out["svfid"] = run()
        out["rows"] = int(rows.shape[0])
        samples = multihost.to_host(rows)
    out["sampler_err"] = float(np.abs(samples - one[0].cpu().numpy()).max())
    out["launches_one"], out["sifid_one"], out["svfid_one"] = one[1:]
    out["stages"] = cfg.stop_scale
    return out


_case_sampling.joins_itself = True


@pytest.mark.parametrize("ranks", [1, 4])
def test_sharded_sampling_in_an_nccl_group_equals_one_process(tmp_path,
                                                              ranks):
    """Over NCCL: the multi-process helpers (rank 0's float, seed and
    string on every rank, the min and max over the ranks, the ranks' rows
    gathered in rank order, a string too long for the broadcast refused on
    every rank); the moving-stat sampler with pallas_fused_sampling, each
    rank its rows of 8 samples with K1 at every refinement stage, gathered
    equal to one process's 8 within 1e-4; and the on-device SIFID of 8
    images and SVFID of 8 clips (per-sample BatchNorm), the same on every
    rank, within rtol 1e-3 of one process's."""
    _cards(ranks)
    outs = run_ranks(__file__, "sampling", tmp_path, world=ranks,
                     timeout=600)
    for out in outs:
        assert out["agree"] == (2.5, 7, (0.5, ranks - 0.5), "rank 0")
        flat, ids = out["gathered"]
        np.testing.assert_array_equal(
            flat, np.repeat(np.arange(ranks, dtype=np.float32), 2)[:, None]
            * np.ones((1, 3), np.float32))
        assert ids.dtype == np.int64 and ids.tolist() == list(range(ranks))
        assert out["long_raised"]
        assert out["rows"] == 8 // ranks
        assert out["launches"] == out["launches_one"] == out["stages"]
        assert out["sampler_err"] <= 1e-4
        for metric in ("sifid", "svfid"):
            assert out[metric] == outs[0][metric]
            np.testing.assert_allclose(out[metric], out[metric + "_one"],
                                       rtol=1e-3)


# ------------------------------------------------------------------ CLI ---

def _leaves(tree):
    """The arrays of a checkpoint pytree, in a fixed order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [np.asarray(tree)]


def _experiment(run):
    exps = glob.glob(os.path.join(run, "**", "experiment_*"), recursive=True)
    assert len(exps) == 1, exps
    return exps[0]


def test_train_cli_on_a_mesh_equals_split_step(tmp_path):
    """train_image --mesh-data 2 --mesh-sp 2 under torchrun, four ranks
    in chunks of 2 (a graph at every scale), ends every scale bit for bit
    as the same run under --split-step: every netG and netD and the
    amps."""
    _cards(4)
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["OMP_NUM_THREADS"] = "1"
    exps = {}
    for name, extra in (("graph", []), ("split", ["--split-step"])):
        out = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "4", __file__, "train_image", *TINY,
             "--steps-per-call", "2", "--batch-size", "2", "--mesh-data",
             "2", "--mesh-sp", "2", "--dist-coordinator", "auto",
             "--run-dir", str(tmp_path / name), *extra],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
        assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-5000:]
        exps[name] = _experiment(str(tmp_path / name))
    modes = {}
    for name, exp in exps.items():
        with open(os.path.join(exp, "logbook.txt")) as f:
            modes[name] = re.findall(
                r"scale \d+: chunks of \d+ iterations, (.*)", f.read())
    assert modes == {"graph": ["graph (4 NCCL ranks)"] * 5,
                     "split": ["eager (split-step)"] * 5}

    def load(exp, name):
        with open(os.path.join(exp, name), "rb") as f:
            return json.load(f) if name.endswith(".json") else \
                pickle.load(f)

    graph, split = exps["graph"], exps["split"]
    assert load(graph, "intermediate.json")["noise_amps"] == \
        load(split, "intermediate.json")["noise_amps"]
    names = sorted(f for f in os.listdir(split)
                   if re.fullmatch(r"net[GD]_\d+\.ckpt", f))
    assert len(names) == 8  # netG_0..4, netD_2..4
    assert names == sorted(f for f in os.listdir(graph)
                           if re.fullmatch(r"net[GD]_\d+\.ckpt", f))
    for name in names:
        got, want = _leaves(load(graph, name)), _leaves(load(split, name))
        assert len(got) == len(want) and all(
            np.array_equal(a, b) for a, b in zip(got, want)), name


def _train_image(args):
    """One rank of test_train_cli_on_a_mesh_equals_split_step: the CLI
    with TF32 off and deterministic cuDNN, so that the two runs take the
    same arithmetic."""
    from hpvaegan_tpu_torch import train_image

    _exact_math()
    train_image.main(args)


CASES = {"chunk": _case_chunk, "sampling": _case_sampling}

if __name__ == "__main__":
    if sys.argv[1] == "train_image":
        _train_image(sys.argv[2:])
    else:
        worker_main(CASES)
