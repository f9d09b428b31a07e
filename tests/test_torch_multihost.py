"""The port's multi-process helpers (parallel/multihost.py) and its data axis
(parallel/mesh.py) on the CPU: the single-process identities and the
NullSaver surface (the JAX package's tests/test_multihost.py:17-79 for
its own), then two gloo ranks against one process at the same global batch:
the primitives, batch-statistics BatchNorm with its double backward (in
both the plain and the grouped, --paired-g, layout), and the sharded
sampler in both BatchNorm modes (the moving-stat one through K1's plain
version, whose per-sample seeds each rank offsets by its first global
row), whole and split into one process's sub-batches.

Multi-rank cases run this file as a script, one process per rank
(`run_ranks`), with one thread each; every rank writes its results to
<tmp>/<case>_<rank>.pt, which the test compares. Tolerances: BatchNorm
outputs, statistics and gradients rtol 1e-5 / atol 1e-6 (the ranks sum
their shards' sums in another order than one process's mean); the sampler
atol 1e-5 (its convolutions see batches of another size), split into
sub-batches atol 3e-5 (batches of 1 to 3 rows against 2 and 3: with the
refinement noise off, so that no draw plays a part, per-sample BatchNorm
alone moves the outputs by 1e-5); the two ranks' shared results bit for
bit.
"""

import inspect
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
if __name__ == "__main__":
    sys.path.insert(0, REPO)

from hpvaegan_tpu_torch import config as tcfg  # noqa: E402
from hpvaegan_tpu_torch.models import get_generator  # noqa: E402
from hpvaegan_tpu_torch.ops import norm as tnorm  # noqa: E402
from hpvaegan_tpu_torch.parallel import mesh, multihost  # noqa: E402
from hpvaegan_tpu_torch.parallel import sampling  # noqa: E402
from hpvaegan_tpu_torch.parallel.sampling import sharded_sampler  # noqa: E402
from hpvaegan_tpu_torch.tools.step_parity import he_init_  # noqa: E402
from hpvaegan_tpu_torch.utils.noise import NoiseSource  # noqa: E402
from hpvaegan_tpu_torch.utils.saver import DataSaver  # noqa: E402

torch.set_num_threads(1)

BN_TOL = dict(rtol=1e-5, atol=1e-6)
SAMPLER_TOL = dict(rtol=0, atol=1e-5)
SPLIT_TOL = dict(rtol=0, atol=3e-5)
CFG = dict(nfc=8, latent_dim=8, num_layer=2, enc_blocks=1, img_size=32,
           min_size=16, max_size=32, vae_levels=2)  # 5 scales, 17 -> 33
AMPS = [1.0, 0.3, 0.2, 0.1, 0.05]


# ------------------------------------------------------------- launcher ---

def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_ranks(script: str, case: str, out_dir, *args, world: int = 2,
              timeout: int = 300):
    """Run `script` as `script case rank world port out_dir *args` once per
    rank, concurrently; returns each rank's <out_dir>/<case>_<rank>.pt.
    A rank that fails ends the others (they would wait for it). free_port's
    port can be taken by another process before rank 0 binds it: the ranks
    then run again on a new port, twice at most."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["OMP_NUM_THREADS"] = "1"
    for attempt in range(3):
        port = free_port()
        logs = [tempfile.TemporaryFile("w+") for _ in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, script, case, str(r), str(world), str(port),
             str(out_dir), *map(str, args)],
            stdout=log, stderr=subprocess.STDOUT, env=env, text=True)
            for r, log in enumerate(logs)]
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs) \
                and not any(p.poll() for p in procs):
            if time.monotonic() > deadline:
                for p in procs:
                    p.kill()
                raise TimeoutError(f"{case}: the ranks ran past {timeout} s")
            time.sleep(0.1)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read())
            log.close()
        if attempt < 2 and any("EADDRINUSE" in out for out in outs):
            continue
        break
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
    return [torch.load(os.path.join(str(out_dir), f"{case}_{r}.pt"),
                       weights_only=False) for r in range(world)]


def worker_main(cases) -> None:
    """A rank of run_ranks: join the gloo group on the CPU (unless the case
    `joins_itself`, from the port in its `.port`), run cases[case](rank,
    world, out_dir, *args) and save its result."""
    case, rank, world, port, out_dir = sys.argv[1:6]
    rank, world, fn = int(rank), int(world), cases[case]
    fn.port = port
    if not getattr(fn, "joins_itself", False):
        multihost.init_distributed(f"127.0.0.1:{port}", world, rank,
                                   backend="gloo", device="cpu")
    result = fn(rank, world, out_dir, *sys.argv[6:])
    torch.save(result, os.path.join(out_dir, f"{case}_{rank}.pt"))
    multihost.sync()


# ------------------------------------------------------ single process ---

def test_single_process_helpers_are_identity():
    """Every helper is the identity and issues no collective in a
    single-process run (they run inside the trainers unconditionally)."""
    assert not multihost.is_multiprocess()
    assert multihost.is_primary()
    assert multihost.process_count() == 1
    assert multihost.agree_seed(123) == 123
    assert multihost.agree_seed(None) is None
    assert multihost.broadcast_str("abc") == "abc"
    multihost.sync("noop")
    x = torch.arange(6.0).reshape(2, 3)
    np.testing.assert_array_equal(multihost.to_host(x), x.numpy())
    a, b = multihost.to_host((x, x + 1))  # the tuple form
    np.testing.assert_array_equal(a, x.numpy())
    np.testing.assert_array_equal(b, x.numpy() + 1)
    assert multihost.agree_float(2.5) == 2.5
    assert multihost.agree_minmax(2.5) == (2.5, 2.5)
    sentinel = object()
    assert multihost.select_saver(None, lambda: sentinel) is sentinel
    # the trivial data group: no collective, the identity
    group = mesh.active()
    assert group.size == 1 and mesh.make_data_group(1) == group
    assert mesh.local_rows(5) == 5
    t = torch.ones(3, requires_grad=True)
    assert mesh.all_reduce_sum(t) is t
    grads = [torch.ones(2), torch.zeros(3)]
    assert mesh.mean_(grads)[0] is grads[0]
    metrics = {"a": torch.tensor(1.0)}
    assert mesh.mean_metrics(metrics) is metrics
    # the draws are the generator's own, at the asked shape
    torch.testing.assert_close(
        NoiseSource(0, "cpu").normal((6, 2)),
        torch.randn((6, 2), generator=torch.Generator().manual_seed(0)),
        rtol=0, atol=0)


def test_nullsaver_matches_datasaver_surface():
    """Every public method of DataSaver exists on NullSaver with the same
    parameters, and so do the attributes the trainers and eval read."""
    from hpvaegan_tpu_torch.parallel.multihost import NullSaver

    for name, fn in inspect.getmembers(DataSaver, inspect.isfunction):
        if name.startswith("_"):
            continue
        null_fn = getattr(NullSaver, name, None)
        assert null_fn is not None, f"NullSaver lacks {name}"
        assert (inspect.signature(fn).parameters.keys()
                == inspect.signature(null_fn).parameters.keys()), name
    s = NullSaver(None, experiment_dir="/x/exp")
    assert (s.experiment_dir, s.eval_dir, s.image_dir) == \
        ("/x/exp", "/x/exp/eval", None)


def test_nullsaver_writes_nothing_reads_shared_dir(tmp_path):
    from hpvaegan_tpu_torch.parallel.multihost import NullSaver

    with open(tmp_path / "netD_0.ckpt", "wb") as f:
        pickle.dump({"params": {"w": 1}}, f)
    with open(tmp_path / "intermediate.json", "w") as f:
        f.write('{"scale_idx": 0}')
    s = NullSaver(None, experiment_dir=str(tmp_path))
    s.save_checkpoint({"x": 1}, "netG_0.ckpt")
    s.save_json({"a": 1}, "other.json")
    s.save_inflight(0, {"G": {}}, 4, [1.0])
    s.finalize_scale(0, [1.0], {"x": 1}, {"y": 2}, rng={"r": 1})
    s.save_image(np.zeros((1, 4, 4, 3)), "real_1.jpg")
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "intermediate.json", "netD_0.ckpt"]
    assert s.load_checkpoint("netD_0.ckpt")["params"] == {"w": 1}
    assert s.load_json("intermediate.json") == {"scale_idx": 0}


def test_a_single_process_refuses_a_data_axis():
    """--mesh-data > 1 or --mesh-sp > 1 in one process raises and says how
    to launch the ranks; a lone process count or id needs a
    coordinator."""
    with pytest.raises(ValueError, match="--dist-nprocs 2 --dist-procid"):
        mesh.make_data_group(2)
    with pytest.raises(ValueError, match="--dist-nprocs 3"):
        mesh.eval_group(3)
    with pytest.raises(ValueError, match="--mesh-sp 2 runs one rank per "
                       "device: launch 2 processes .* --dist-nprocs 2"):
        mesh.make_data_group(1, mesh_sp=2)
    cfg = tcfg.Config(dist_nprocs=2)
    with pytest.raises(ValueError, match="--dist-nprocs needs --dist-coord"):
        multihost.init_from_cfg(cfg, "cpu")
    cfg = tcfg.Config(dist_coordinator="127.0.0.1:1")
    with pytest.raises(ValueError, match="needs --dist-nprocs and --dist-"):
        multihost.init_from_cfg(cfg, "cpu")
    assert not multihost.is_multiprocess()


def test_sharded_noise_slices_the_global_draws():
    """Under a data group, rank r of N draws rows [r b, (r + 1) b) of what
    one process draws at N b (of each group of a grouped draw), scalars
    whole, and offsets K1's seeds by r b; in a window, rows [start,
    start + b) of a draw of `total` rows, whatever the group."""
    one = NoiseSource(3, "cpu")
    want = [one.normal((4, 2, 3)), one.uniform(), one.bernoulli((4,)),
            one.randint(7, (4,)), one.uniform((4, 5))]
    seeds = one.seed()
    for rank in range(2):
        with mesh.data_parallel(mesh.DataGroup(rank, 2)):
            s = NoiseSource(3, "cpu")
            got = [s.normal((2, 2, 3)), s.uniform(), s.bernoulli((2,)),
                   s.randint(7, (2,)), s.uniform((2, 5))]
            assert s.batch_seed(2) == seeds + 2 * rank
            assert mesh.local_rows(4) == 2
            with pytest.raises(ValueError, match="does not split"):
                mesh.local_rows(3)
        rows = slice(2 * rank, 2 * rank + 2)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w if w.ndim == 0 else w[rows],
                                       rtol=0, atol=0)
    # the paired forward's draw: two groups of 4 rows in one process,
    # each rank its 2 rows of each group
    whole = NoiseSource(4, "cpu").normal((8, 3))
    for rank in range(2):
        with mesh.data_parallel(mesh.DataGroup(rank, 2)):
            got = NoiseSource(4, "cpu").grouped_normal((4, 3), 2)
        rows = [2 * rank, 2 * rank + 1, 4 + 2 * rank, 5 + 2 * rank]
        torch.testing.assert_close(got, whole[rows], rtol=0, atol=0)
    # a window: rows 3..4 of a 5-row draw, then back to the group's rows
    with mesh.data_parallel(mesh.DataGroup(1, 2)):
        s = NoiseSource(5, "cpu")
        with s.window(5, 3):
            got = s.normal((2, 3))
            assert s.batch_seed(2) == NoiseSource(5, "cpu").seed() + 3
        after = s.normal((1, 3))
    ref = NoiseSource(5, "cpu")
    torch.testing.assert_close(got, ref.normal((5, 3))[3:], rtol=0, atol=0)
    torch.testing.assert_close(after, ref.normal((2, 3))[1:], rtol=0, atol=0)


# ----------------------------------------------------------- two ranks ---

def _case_primitives(rank, world, out_dir):
    lo, hi = multihost.agree_minmax(float(rank))
    assert (lo, hi) == (0.0, float(world - 1)), (lo, hi)
    raised = False
    try:
        multihost.broadcast_str("x" * 5000 if multihost.is_primary() else "",
                                max_len=4096)
    except ValueError:
        raised = True
    exact = multihost.broadcast_str(
        "y" * 4096 if multihost.is_primary() else "", max_len=4096)
    seed = multihost.agree_seed(7 + rank * 1000)
    value = multihost.agree_float(1.5 + rank)
    rows = torch.arange(6.0).reshape(2, 3) + 10 * rank
    gathered, other = multihost.to_host((rows, rows[:, :1].long()))
    saver = multihost.select_saver(
        None, lambda: multihost.NullSaver(None, experiment_dir=out_dir))
    group = mesh.make_data_group(world)
    with mesh.data_parallel(group):
        summed = mesh.all_reduce_sum(torch.tensor([rank + 1.0]))
        means = mesh.mean_([torch.tensor([2.0 * rank]),
                            torch.tensor([[rank], [1.0]])])
        metrics = mesh.mean_metrics({"a": torch.tensor(float(rank)),
                                     "b": torch.tensor(4.0)})
    return dict(raised=raised, exact=exact, seed=seed, value=value,
                gathered=gathered, other=other, exp=saver.experiment_dir,
                saver=type(saver).__name__, summed=summed,
                means=[m.numpy() for m in means],
                metrics={k: float(v) for k, v in metrics.items()},
                group=(group.rank, group.size))


def test_two_rank_primitives(tmp_path):
    """agree_minmax, agree_seed, agree_float, broadcast_str (raising on
    BOTH ranks for a long primary string, exact at max_len), to_host,
    select_saver and the data group's reductions, over two gloo ranks."""
    r0, r1 = run_ranks(__file__, "primitives", tmp_path)
    for r, out in enumerate((r0, r1)):
        assert out["raised"], f"rank {r} accepted an over-long string"
        assert out["exact"] == "y" * 4096
        assert out["seed"] == 7 and out["value"] == 1.5
        np.testing.assert_array_equal(
            out["gathered"], np.concatenate([np.arange(6.0).reshape(2, 3),
                                             np.arange(6.0).reshape(2, 3)
                                             + 10]))
        assert out["other"].dtype == np.int64
        np.testing.assert_array_equal(out["other"][:, 0], [0, 3, 10, 13])
        assert out["exp"] == str(tmp_path)
        assert out["group"] == (r, 2)
        assert float(out["summed"]) == 3.0
        np.testing.assert_array_equal(out["means"][0], [1.0])
        np.testing.assert_array_equal(out["means"][1], [[0.5], [1.0]])
        assert out["metrics"] == {"a": 0.5, "b": 4.0}
    assert r0["saver"] == "NullSaver" and r1["saver"] == "NullSaver"


def _bn_problem(groups, ndim):
    """A global batch of 4 per group, the BatchNorm state and a fixed
    output weighting, from a numpy seed."""
    rng = np.random.RandomState(groups + 10 * ndim)
    spatial = (5, 6) if ndim == 2 else (3, 5, 6)
    x = (rng.randn(4 * groups, 3, *spatial) * 2 + 0.5).astype(np.float32)
    w = rng.randn(*x.shape).astype(np.float32)
    gamma = (1 + 0.1 * rng.randn(3)).astype(np.float32)
    beta = (0.1 * rng.randn(3)).astype(np.float32)
    mean = (0.1 * rng.randn(3)).astype(np.float32)
    var = rng.uniform(0.5, 1.5, 3).astype(np.float32)
    return x, w, gamma, beta, mean, var


def _bn_run(groups, ndim, rows):
    """BatchNorm in batch mode on `rows` of each group of the global batch,
    then a gradient-penalty-like loss: the mean square of the gradient of
    sum(w * y) with respect to x (create_graph), differentiated again.
    Returns y, the folded stats, and the loss's gradients."""
    x, w, gamma, beta, mean, var = (torch.from_numpy(a) for a in
                                    _bn_problem(groups, ndim))
    per = x.shape[0] // groups
    pick = torch.cat([torch.arange(g * per, (g + 1) * per)[rows]
                      for g in range(groups)])
    x, w = x[pick].clone().requires_grad_(True), w[pick]
    gamma.requires_grad_(True)
    beta.requires_grad_(True)
    y, m, v = tnorm.batchnorm(x, gamma, beta, mean, var, "batch",
                              groups=groups)
    g, = torch.autograd.grad((w * y).sum(), x, create_graph=True)
    loss = (g ** 2).mean() + (y ** 2).mean()
    grads = torch.autograd.grad(loss, (x, gamma, beta))
    return dict(y=y.detach().numpy(), mean=m.detach().numpy(),
                var=v.detach().numpy(),
                x_grad=grads[0].numpy(), gamma_grad=grads[1].numpy(),
                beta_grad=grads[2].numpy(), loss=float(loss.detach()))


def _case_bn(rank, world, out_dir, groups, ndim):
    with mesh.data_parallel(mesh.make_data_group(world)):
        return _bn_run(int(groups), int(ndim),
                       slice(2 * rank, 2 * rank + 2))


@pytest.mark.parametrize("groups,ndim", [(1, 2), (2, 2), (1, 3)])
def test_two_rank_batchnorm_and_double_backward(tmp_path, groups, ndim):
    """Batch-mode BatchNorm on 2 ranks x 2 rows equals 1 process x 4: the
    output rows, the folded moving statistics, and the gradients of a loss
    that differentiates a gradient through it (the GP's double backward).
    Per rank, the loss is its shards' mean and its parameter gradients
    average to the global ones; x's rows take N times the global loss's
    gradient (each rank's backward sums every rank's terms). groups=2: the
    --paired-g layout, each half with its own global statistics."""
    want = _bn_run(groups, ndim, slice(0, 4))
    outs = run_ranks(__file__, "bn", tmp_path, groups, ndim)
    for r, out in enumerate(outs):
        per = want["y"].shape[0] // groups
        rows = np.concatenate([np.arange(g * per + 2 * r, g * per + 2 * r + 2)
                               for g in range(groups)])
        np.testing.assert_allclose(out["y"], want["y"][rows], **BN_TOL)
        np.testing.assert_allclose(out["x_grad"] / 2, want["x_grad"][rows],
                                   **BN_TOL)
        for k in ("mean", "var"):
            np.testing.assert_allclose(out[k], want[k], **BN_TOL)
            np.testing.assert_array_equal(out[k], outs[0][k])
    for k in ("gamma_grad", "beta_grad"):
        np.testing.assert_allclose((outs[0][k] + outs[1][k]) / 2, want[k],
                                   **BN_TOL)
    np.testing.assert_allclose((outs[0]["loss"] + outs[1]["loss"]) / 2,
                               want["loss"], rtol=1e-6)


def _sampler_generator(fused):
    cfg = tcfg.Config(**CFG).finalize()
    cfg.ar = 1.0
    cfg.Noise_Amps = AMPS
    cfg.pallas_fused_sampling = fused
    G = get_generator("GeneratorHPVAEGAN", 2)(cfg)
    for _ in range(cfg.stop_scale):
        G.init_next_stage()
    # unit-scale activations and moving statistics off (0, 1)
    he_init_(G, torch.Generator().manual_seed(0))
    return cfg, G.eval()


def _per_sample(cfg, G):
    """The sampler's elements per sample (its widest activation)."""
    from hpvaegan_tpu_torch.utils import pyramid

    h0, w0 = pyramid.scale_size_2d(0, cfg.scale_factor, cfg.stop_scale,
                                   cfg.img_size, cfg.ar)
    return sampling.generator_elements(cfg, G, 2, (h0, w0, cfg.latent_dim))


def _split_elements(cfg, G):
    """A MAX_ELEMENTS that splits 8 samples into sub-batches of 3 rows at
    most: [0, 2), [2, 5), [5, 8), one across the ranks' boundary at 4."""
    return 3 * _per_sample(cfg, G)


def _case_sampler(rank, world, out_dir, mode, split=""):
    from hpvaegan_tpu_torch.ops import fused_upscale_noise as k1

    cfg, G = _sampler_generator(mode == "moving")
    if split:
        sampling.MAX_ELEMENTS = _split_elements(cfg, G)
    with mesh.data_parallel(mesh.eval_group()):
        sample = sharded_sampler(cfg, G, train=mode == "sample")
        local = sample(8, NoiseSource(5, "cpu"))
        full = multihost.to_host(local)
    return dict(local=local.numpy(), full=full,
                launches=k1.fused_upscale_noise_2d.launches)


@pytest.mark.parametrize("mode", ["sample", "moving"])
def test_two_rank_sampler_equals_one_process(tmp_path, mode):
    """sharded_sampler over 2 ranks x 4 samples equals 1 process x 8, per-
    sample BatchNorm and moving statistics with K1's plain version (which
    draws sample b's noise from seed + b: rank 1 offsets its seeds by 4),
    and the gather hands both ranks all 8."""
    cfg, G = _sampler_generator(mode == "moving")
    with torch.no_grad():
        want = sharded_sampler(cfg, G, train=mode == "sample")(
            8, NoiseSource(5, "cpu")).numpy()
    outs = run_ranks(__file__, "sampler", tmp_path, mode)
    for r, out in enumerate(outs):
        assert out["local"].shape == (4,) + want.shape[1:]
        np.testing.assert_allclose(out["local"], want[4 * r:4 * r + 4],
                                   **SAMPLER_TOL)
        np.testing.assert_array_equal(out["full"], np.concatenate(
            [outs[0]["local"], outs[1]["local"]]))
        assert out["launches"] == 0  # CPU tensors: the plain version
    # the refinement noise moves the samples far more than the tolerance,
    # so rank 1 drew its rows' noise (in moving mode: from seeds + 4)
    cfg.Noise_Amps = [1.0] + [0.0] * (len(AMPS) - 1)
    with torch.no_grad():
        quiet = sharded_sampler(cfg, G, train=mode == "sample")(
            8, NoiseSource(5, "cpu")).numpy()
    assert np.abs(want - quiet)[4:].max() > 20 * SAMPLER_TOL["atol"]


@pytest.mark.parametrize("mode", ["sample", "moving"])
def test_two_rank_sampler_splits_as_one_process(tmp_path, mode, monkeypatch):
    """With a MAX_ELEMENTS that splits 8 samples into [0, 2), [2, 5),
    [5, 8) in one process, 2 ranks x 4 samples still equal that process:
    each rank runs every sub-batch on its rows in it (rank 0: 2, 2 and
    none; rank 1: none, 1 and 3) from that sub-batch's draws."""
    cfg, G = _sampler_generator(mode == "moving")
    monkeypatch.setattr(sampling, "MAX_ELEMENTS", _split_elements(cfg, G))
    assert sampling.sub_batches(8, _per_sample(cfg, G)) == [(0, 2), (2, 5),
                                                           (5, 8)]
    with torch.no_grad():
        want = sharded_sampler(cfg, G, train=mode == "sample")(
            8, NoiseSource(5, "cpu")).numpy()
    outs = run_ranks(__file__, "sampler", tmp_path, mode, "split")
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["local"], want[4 * r:4 * r + 4],
                                   **SPLIT_TOL)
        np.testing.assert_array_equal(out["full"], np.concatenate(
            [outs[0]["local"], outs[1]["local"]]))
    # unsplit, one process draws other noise: the split's draws are held
    monkeypatch.setattr(sampling, "MAX_ELEMENTS", 2 ** 31 - 1)
    with torch.no_grad():
        whole = sharded_sampler(cfg, G, train=mode == "sample")(
            8, NoiseSource(5, "cpu")).numpy()
    assert np.abs(want - whole)[2:].max() > 20 * SPLIT_TOL["atol"]


CASES = {"primitives": _case_primitives, "bn": _case_bn,
         "sampler": _case_sampler}

if __name__ == "__main__":
    worker_main(CASES)
