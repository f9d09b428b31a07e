"""The spatial axis (--mesh-sp, parallel/spatial.py) under the CSG/SG video
baselines over gloo ranks on the CPU, held against one process and against
the JAX package's ('data', 'sp') mesh.

The baselines' stages zero-pad their input by p rows a side and run
padding-0 convolutions, and their critic pads by num_layer + 2: under the
axis an activation of unpadded height H is held in the padded layout
(H, p), whose edge ranks hold the p pad rows. At S = 2 both ranks are edge
ranks and the shards stay equal; from S = 3 on the middle ranks hold H / S
rows and the edge ranks H / S + p, so every case below runs S = 4.

  (a) The primitives at S = 4 and at S = 2, each rank on its rows, against
      one process on the whole: the sharded zero pad of a height 12 by 3
      (at S = 4 the ranks hold 6, 3, 3 and 6 rows) and a chain of three
      padding-0 conv3d on it, in forward, backward and the gradient
      penalty's double backward; resize_trilinear_padded from each height
      of the pyramid 12 15 17 20 24 to the next padded by 3 (at S = 4 the
      four transitions between a split and a whole height), bit for bit,
      and its backward; draw_rows over a padded layout, bit for bit;
      batch BatchNorm over the layout (12, 2) and its double backward;
      WDiscriminatorBaselines' scores in the layout (20, 4) and their
      input gradient, and their weighted mean (spatial.mean) averaged over
      the ranks. Tolerances are the data axis's: rtol 1e-4 / atol 2e-5.
  (b) One D step and then one G step of GeneratorCSG and of GeneratorSG at
      scale 3 of the pyramid 12 15 17 20 (num_layer 2: CSG's stages pad by
      3, SG's by 4, the critic by 4; at S = 4 and at S = 2 the heights 12
      and 20 split and 15 and 17 stay whole, so the sharded head and first
      stage, two replicated stages and a sharded last stage and critic run
      in one forward), on S = 4 ranks and on D = 2 x S = 2 ranks, with the
      JAX draws of one process replayed and cut to each rank's rows of B
      and H, against JAX `make_d_step` / `make_g_step` with
      `make_baseline_g_apply` over `make_mesh(4, data_parallel=1)` and
      `make_mesh(4, data_parallel=2)` of the conftest's virtual devices,
      the JAX BatchNorm's statistics reduced in float64
      (test_torch_baselines.py::float64_batchnorm says why): metrics rtol
      1e-4 / atol 1e-7, gradients and BatchNorm / spectral-norm state rtol
      1e-4 / atol 2e-5 (test_torch_data_parallel.py's); every rank's
      results bit-equal.
  (c) The planted faults that (b) must catch, each on S = 4 ranks with
      GeneratorCSG: BatchNorm of a padded layout counted as equal shards,
      the critic's score means not weighted, the edge ranks' rows not
      dropped after a padding-0 convolution (the edge ranks' stage output
      then no longer fits its rows of H, and the run fails), and the
      random-mode stage input's noise drawn at the first rows of the
      padded height.

Ranks run this file as a script (test_torch_multihost.py::run_ranks).
"""

import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
if __name__ == "__main__":
    sys.path.insert(0, REPO)

from hpvaegan_tpu_torch import config as tcfg  # noqa: E402
from hpvaegan_tpu_torch import optim as toptim  # noqa: E402
from hpvaegan_tpu_torch.models import get_generator  # noqa: E402
from hpvaegan_tpu_torch.models.networks_3d import (  # noqa: E402
    WDiscriminatorBaselines, _zero_pad)
from hpvaegan_tpu_torch.ops import norm as tnorm  # noqa: E402
from hpvaegan_tpu_torch.ops.conv import conv  # noqa: E402
from hpvaegan_tpu_torch.ops.resize import (  # noqa: E402
    resize_trilinear, resize_trilinear_padded)
from hpvaegan_tpu_torch.parallel import mesh, spatial  # noqa: E402
from hpvaegan_tpu_torch.tools.step_parity import he_init_  # noqa: E402
from hpvaegan_tpu_torch.training import partition as tpart  # noqa: E402
from hpvaegan_tpu_torch.training import steps as tsteps  # noqa: E402
from hpvaegan_tpu_torch.training.state import ScaleTrainState  # noqa: E402
from hpvaegan_tpu_torch.utils.noise import NoiseSource  # noqa: E402

from test_torch_data_parallel import ShardedReplay, _rank_rows  # noqa: E402
from test_torch_multihost import run_ranks, worker_main  # noqa: E402
from test_torch_spatial import PARAM_GRADS, TOL, _problem  # noqa: E402

torch.set_num_threads(1)

# img 32, min 16, ar 0.75: heights 12 15 17 20 24, widths 17 20 23 27 33;
# 12, 20 and 24 split at S = 4 and at S = 2, 15 and 17 never
PYRAMID = dict(img_size=32, min_size=16, max_size=32)
AR = 0.75
HEIGHTS = [12, 15, 17, 20, 24]
H, PAD = 12, 3  # (a)'s padded layout
# (a)'s rows of each rank of the layouts (12, 3), (12, 2) and (20, 4), and
# of the equal split of 12, at S = 4 and at S = 2: (first row, rows)
ROWS = {
    4: {(12, 3): [(0, 6), (6, 3), (9, 3), (12, 6)],
        (12, 2): [(0, 5), (5, 3), (8, 3), (11, 5)],
        (20, 4): [(0, 9), (9, 5), (14, 5), (19, 9)],
        (12, 0): [(0, 3), (3, 3), (6, 3), (9, 3)]},
    2: {(12, 3): [(0, 9), (9, 9)], (12, 2): [(0, 8), (8, 8)],
        (20, 4): [(0, 14), (14, 14)], (12, 0): [(0, 6), (6, 6)]},
}


def _pyramid_cfg(**kw):
    cfg = tcfg.Config(**PYRAMID, sampling_rates=[2, 1], org_fps=24.0,
                      fps_lcm=2, **kw).finalize()
    cfg.ar = AR
    return cfg


# ------------------------------------------------------- (a) primitives ---

def _pick(h, p=0):
    """This rank's rows of the layout (h, p) of a whole tensor (all of it
    in one process, or where h is not split)."""
    def pick(t):
        start, n = spatial.rows(h, p)
        return t.narrow(-2, start, n).contiguous()
    return pick


def _chain_run():
    """The sharded zero pad of (2, 2, 3, H, 5) by PAD and three padding-0
    conv3d on it, then sum(q * (d sum(r * y) / dx)^2) + sum(r * y),
    differentiated again (each rank's loss its own elements' sum). In
    float64, as test_torch_spatial.py::_conv_run."""
    def problem(seed, *shape):
        return _problem(seed, *shape).double()

    x = _pick(H)(problem(1, 2, 2, 3, H, 5)).requires_grad_(True)
    ws = [(problem(2 + i, 3, 2 if i == 0 else 3, 3, 3, 3) * 0.3
           ).requires_grad_(True) for i in range(PAD)]
    bs = [problem(5 + i, 3).requires_grad_(True) for i in range(PAD)]
    layout = spatial.layout(H, PAD)
    y = _zero_pad(x, PAD, layout)
    out = {"padded": y.detach()}
    for i, (w, b) in enumerate(zip(ws, bs)):
        y = conv(y, w, b, padding=0, sharded=layout)
        layout = spatial.conv_layout(layout, 3, 0)
        out[f"y{i}"] = y.detach()
    r = _pick(H)(problem(9, 2, 3, 3, H, 5))
    q = _pick(H)(problem(10, 2, 2, 3, H, 5))
    gx, = torch.autograd.grad((r * y).sum(), x, create_graph=True)
    loss = (q * gx ** 2).sum() + (r * y).sum()
    grads = torch.autograd.grad(loss, [x] + ws + bs)
    out.update(gx=gx.detach(), x_grad=grads[0], w_grad=grads[1:1 + PAD],
               b_grad=grads[1 + PAD:])
    return out


def _resize_run(index):
    """resize_trilinear_padded of pyramid scale index - 1 to scale index
    padded by PAD (the baselines' random-mode stage input), on the rank's
    rows of its input, and the gradient of sum(r * y) with respect to the
    input, weighed and summed as test_torch_spatial.py::_upscale_run
    does for a whole output or input. One process: resize_trilinear."""
    h_in, h = HEIGHTS[index - 1], HEIGHTS[index]
    x = _pick(h_in)(_problem(20 + index, 2, 3, 2, h_in, 6)
                    ).requires_grad_(True)
    size = (3, h, 7)
    if spatial.axis().size > 1:
        y = resize_trilinear_padded(x, size, PAD, h_in)
    else:
        y = resize_trilinear(x, tuple(s + 2 * PAD for s in size))
    whole = (2, 3) + tuple(s + 2 * PAD for s in size)
    r = torch.cos(torch.arange(int(np.prod(whole)), dtype=torch.float32))
    weight = 1.0 if spatial.sharded(h) else 1.0 / spatial.axis().size
    x_grad, = torch.autograd.grad(
        (_pick(h, PAD)(r.reshape(whole)) * y).sum() * weight, x)
    if not spatial.sharded(h_in):
        x_grad = spatial.sum_sp(x_grad)
    return dict(y=y.detach(), x_grad=x_grad)


def _bn_run():
    """Batch-mode BatchNorm of the rank's rows of the layout (H, 2) of a
    fixed (4, 3, 2, H + 4, 5) input, then sum(q * (d sum(r * y) / dx)^2)
    + sum(r * y^2), differentiated again."""
    p = 2
    shape = (4, 3, 2, H + 2 * p, 5)
    pick = _pick(H, p)
    x = pick(_problem(30, *shape) * 2 + 0.5).requires_grad_(True)
    gamma = (1 + 0.1 * _problem(31, 3)).requires_grad_(True)
    beta = (0.1 * _problem(32, 3)).requires_grad_(True)
    mean, var = 0.1 * _problem(33, 3), 1 + 0.2 * _problem(34, 3).abs()
    r = pick(_problem(35, *shape))
    q = torch.sin(r)
    y, m, v = tnorm.batchnorm(x, gamma, beta, mean, var, "batch",
                              sharded=spatial.layout(H, p))
    gx, = torch.autograd.grad((r * y).sum(), x, create_graph=True)
    loss = (q * gx ** 2).sum() + (r * y ** 2).sum()
    grads = torch.autograd.grad(loss, (x, gamma, beta))
    return dict(y=y.detach(), mean=m, var=v, x_grad=grads[0],
                gamma_grad=grads[1], beta_grad=grads[2])


def _critic_run():
    """WDiscriminatorBaselines (nfc 4, num_layer 2: pad 4) on the rank's
    rows of a (2, 3, 3, 20, 6) clip: the scores in the layout (20, 4), the
    input gradient of sum(r * scores), and spatial.mean of the scores
    averaged over the ranks."""
    cfg = _pyramid_cfg(nfc=4, num_layer=2)
    D = WDiscriminatorBaselines(cfg)
    he_init_(D, torch.Generator().manual_seed(3))
    h, p = 20, D.score_pad
    x = _pick(h)(_problem(40, 2, 3, 3, h, 6)).requires_grad_(True)
    scores = D(x, sharded=spatial.sharded(h))[0]
    whole = (2, 1, 3 + 2 * p, h + 2 * p, 6 + 2 * p)
    r = _pick(h, p)(_problem(41, *whole))
    x_grad, = torch.autograd.grad((r * scores).sum(), x)
    score_mean = mesh.mean_([spatial.mean(scores.detach(),
                                          spatial.layout(h, p))])[0]
    return dict(scores=scores.detach(), x_grad=x_grad,
                score_mean=score_mean)


def _draws():
    """A normal and a uniform draw of a (2, 3, 4, h + 2 PAD, 5) tensor in
    the layout (h, PAD), with this rank's shape, for h = 12 (split) and
    15 (whole)."""
    out = {}
    for h in (12, 15):
        noise = NoiseSource(3, "cpu")
        shape = (2, 3, 4, spatial.rows(h, PAD)[1], 5)
        out[f"normal_{h}"] = noise.draw_rows(h, "normal", shape, pad=PAD)
        out[f"uniform_{h}"] = noise.draw_rows(h, "uniform", shape, pad=PAD)
    return out


def _primitives():
    out = {"chain": _chain_run(), "bn": _bn_run(), "critic": _critic_run(),
           "draws": _draws()}
    for index in range(1, len(HEIGHTS)):
        out[f"resize_{index}"] = _resize_run(index)
    return out


def _case_primitives(rank, world, out_dir):
    group = mesh.make_data_group(1, world)
    with mesh.data_parallel(group):
        spatial.conv_rows.clear()
        out = _primitives()
        out["conv_rows"] = dict(spatial.conv_rows)
        with torch.no_grad():
            for res in (out["chain"], out["bn"]):
                for k in PARAM_GRADS:
                    if k in res:
                        res[k] = (mesh.sum_all(res[k]) if torch.is_tensor(
                            res[k]) else [mesh.sum_all(g) for g in res[k]])
        out["rows"] = {hp: spatial.rows(*hp) for hp in ROWS[world]}
    return out


def _cut(v, rows):
    return v.narrow(-2, *rows)


@pytest.mark.parametrize("sp", [4, 2])
def test_padded_layout_primitives_equal_one_process(tmp_path, sp):
    """Each rank's zero pad, padding-0 convolutions (with the GP's double
    backward), padded resizes, draws, BatchNorm and critic on its rows of
    a padded layout equal one process's rows of the whole; the
    parameters' gradients summed over the ranks equal one process's."""
    want = _primitives()
    outs = run_ranks(__file__, "primitives", tmp_path, world=sp)
    for s, out in enumerate(outs):
        for hp, rows in ROWS[sp].items():
            assert out["rows"][hp] == rows[s] == spatial_rows(sp, s, *hp)
        rows = {hp: r[s] for hp, r in ROWS[sp].items()}
        # every padding-0 conv ran on the rank's rows and the halo rows
        # inside the global height: the edge ranks on more rows than the
        # middle ones
        edge = s in (0, sp - 1)
        chain = [spatial_rows(sp, s, H, PAD - i)[1] + 1 + (not edge)
                 for i in range(PAD)]
        assert all(out["conv_rows"].get(n) for n in chain), out["conv_rows"]
        got, ref = out["chain"], want["chain"]
        assert torch.equal(got["padded"], _cut(ref["padded"], rows[(12, 3)]))
        for i in range(PAD):
            start, n = spatial_rows(sp, s, 12, PAD - 1 - i)
            torch.testing.assert_close(got[f"y{i}"],
                                       ref[f"y{i}"].narrow(-2, start, n),
                                       **TOL)
        for k in ("gx", "x_grad"):
            torch.testing.assert_close(got[k], _cut(ref[k], rows[(12, 0)]),
                                       **TOL)
        for k in ("w_grad", "b_grad"):
            for i, (g, w) in enumerate(zip(got[k], ref[k])):
                torch.testing.assert_close(g, w, **TOL)
                assert torch.equal(g, outs[0]["chain"][k][i]), (k, i)
        got, ref = out["bn"], want["bn"]
        for k in ("y", "x_grad"):
            torch.testing.assert_close(got[k], _cut(ref[k], rows[(12, 2)]),
                                       **TOL)
        for k in ("mean", "var", "gamma_grad", "beta_grad"):
            torch.testing.assert_close(got[k], ref[k], **TOL)
            assert torch.equal(got[k], outs[0]["bn"][k]), k
        got, ref = out["critic"], want["critic"]
        torch.testing.assert_close(got["scores"],
                                   _cut(ref["scores"], rows[(20, 4)]), **TOL)
        torch.testing.assert_close(got["x_grad"],
                                   _cut(ref["x_grad"], spatial_rows(
                                       sp, s, 20, 0)), **TOL)
        torch.testing.assert_close(got["score_mean"],
                                   ref["scores"].mean(), **TOL)
        for h in (12, 15):
            cut = spatial_rows(sp, s, h, PAD) if h % sp == 0 else \
                (0, h + 2 * PAD)
            for kind in ("normal", "uniform"):
                k = f"{kind}_{h}"
                assert torch.equal(out["draws"][k],
                                   _cut(want["draws"][k], cut)), k
        for index in range(1, len(HEIGHTS)):
            got, ref = out[f"resize_{index}"], want[f"resize_{index}"]
            h_in, h = HEIGHTS[index - 1], HEIGHTS[index]
            cut = spatial_rows(sp, s, h, PAD) if h % sp == 0 else \
                (0, h + 2 * PAD)
            # the same gathers and lerps: bit-equal
            assert torch.equal(got["y"], _cut(ref["y"], cut)), index
            cut = spatial_rows(sp, s, h_in, 0) if h_in % sp == 0 else \
                (0, h_in)
            torch.testing.assert_close(got["x_grad"], _cut(ref["x_grad"],
                                                           cut), **TOL)


def spatial_rows(sp, s, h, p):
    """Rank s's (first row, rows) of the layout (h, p) over sp ranks."""
    n = h // sp
    return (0 if s == 0 else p + s * n), n + p * (s == 0) + p * (s == sp - 1)


# --------------------------------------------- (b) one D + G step vs JAX ---

SCALE = 3  # heights 12 15 17 20: 12 and 20 split at S = 4 and at S = 2
GENS = ("GeneratorCSG", "GeneratorSG")
FAULTS = ("bn_equal_shards", "scores_unweighted", "edges_kept",
          "padded_draws_first_rows")


def _plant(fault):
    """Break one part of the padded layouts in this process, as `fault`
    names it."""
    if fault == "bn_equal_shards":
        tnorm._elements = lambda xf, groups, ranks, sharded: (
            xf.numel() // (groups * xf.shape[1]) * ranks)
    elif fault == "scores_unweighted":
        spatial.mean = lambda t, sharded: torch.mean(t)
    elif fault == "edges_kept":
        spatial.drop_edges = lambda x, k: x
    elif fault == "padded_draws_first_rows":
        draw_rows = NoiseSource.draw_rows

        def first_rows(self, h, kind, shape, *args, pad=0):
            if not pad or not spatial.sharded(h):
                return draw_rows(self, h, kind, shape, *args, pad=pad)
            shape = tuple(shape)
            whole = getattr(self, kind)(shape[:-2] + (h + 2 * pad,
                                                      shape[-1]), *args)
            return whole.narrow(-2, 0, shape[-2])

        NoiseSource.draw_rows = first_rows
    elif fault != "none":
        raise ValueError(fault)


def _case_step(rank, world, out_dir, name, data_ranks, fault):
    """This rank's rows of the batch (of B by the data axis, of H where
    the spatial axis splits it), the D step then the G step; the metrics,
    gradients and states."""
    _plant(fault)
    data_ranks = int(data_ranks)
    p = torch.load(os.path.join(out_dir, f"{name}.pt"), weights_only=False)
    ct = p["ct"]
    G = get_generator(name, 3)(ct)
    while len(G.body) < SCALE + 1:
        G.init_next_stage()
    G.load_state_dict(p["g"])
    G.z_init = p["z_init"]
    D = WDiscriminatorBaselines(ct)
    D.load_state_dict(p["d"])
    st = ScaleTrainState(
        G, D, toptim.ClippedAdam(tpart.apply_lr_plan(G, p["plan"]), ct.beta1,
                                 grad_clip=float("inf")),
        toptim.adam(D.parameters(), ct.lr_d, ct.beta1), None)
    group = mesh.make_data_group(data_ranks, world // data_ranks)
    out = {}
    with mesh.data_parallel(group):
        real, real_zero, noise_init = (spatial.shard_rows(_rank_rows(t))
                                       for t in p["batch"])
        st.noise = ShardedReplay(p["d_draws"])
        out["d_metrics"] = {k: float(v) for k, v in mesh.mean_metrics(
            tsteps.d_step(ct, st, real, noise_init, p["amps"])).items()}
        out["d_grads"] = {k: q.grad.clone() for k, q in D.named_parameters()}
        out["d_sd"] = {k: v.clone() for k, v in D.state_dict().items()}
        st.noise = ShardedReplay(p["g_draws"])
        out["g_metrics"] = {k: float(v) for k, v in mesh.mean_metrics(
            tsteps.g_step(ct, st, real, real_zero, noise_init, p["amps"],
                          vae_phase=False)).items()}
        assert not st.noise.drawn
    out["g_grads"] = {k: q.grad.clone() for k, q in G.named_parameters()
                      if q.grad is not None}
    out["g_sd"] = {k: v.clone() for k, v in G.state_dict().items()}
    out["shapes"] = (tuple(real.shape), tuple(real_zero.shape),
                     tuple(noise_init.shape))
    return out


@pytest.fixture(scope="module")
def jax_steps(tmp_path_factory):
    """Per generator, the step's payload for the ranks (weights, Z_init,
    batch, the JAX draws of one process) and JAX's D and G steps over both
    meshes, with float64 BatchNorm statistics."""
    import jax
    import jax.numpy as jnp
    import optax

    from hpvaegan_tpu import optim as joptim
    from hpvaegan_tpu.models import blocks as jblocks
    from hpvaegan_tpu.models import networks_3d as jnet
    from hpvaegan_tpu.parallel.mesh import make_mesh
    from hpvaegan_tpu.training import baselines_trainer as jbase
    from hpvaegan_tpu.training import partition as jpart
    from hpvaegan_tpu.training import steps as jsteps
    from hpvaegan_tpu.training.state import ScaleTrainState as JState

    import test_torch_baselines as tb
    from test_torch_video import _ncdhw, _stage_thw

    def capture():
        """An optax stage that keeps the gradients it is given in its
        state: the jitted steps' gradients, read from their output."""
        return optax.GradientTransformation(
            lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
            lambda updates, state, params=None: (updates, updates))

    path = tmp_path_factory.mktemp("spatial_baselines_step")
    out = {"path": path}
    key = jax.random.PRNGKey(3)
    # the steps' keys (steps.py:159, 193 there): the D step's fake draws
    # from k_fake and its GP alpha from k_alpha, the G step's fake from
    # k_fake2 of the key the D step hands on (asserted below)
    key_g, k_fake, k_alpha = jax.random.split(key, 3)
    _, _, k_fake2 = jax.random.split(key_g, 3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jblocks, "batchnorm_apply",
                   tb.float64_batchnorm(jblocks.batchnorm_apply))
        for name in GENS:
            cj, ct = tb._bcfgs(name)
            for c in (cj, ct):
                c.scale_idx = SCALE
            assert [_stage_thw(cj, i)[1] for i in range(SCALE + 1)] == \
                HEIGHTS[:SCALE + 1]
            n = SCALE + 1
            g0, gs0 = tb._jax_generator(cj, name, n, seed=0)
            d0, ds0 = tb._jax_discriminator(cj, seed=7)
            z_init = tb._z(cj, 1, 3)
            has = dict(has_head="head" in g0, has_tail="tail" in g0)
            plan = jpart.make_baseline_lr_plan(cj, SCALE, n, **has)
            trainable = jpart.split_params(g0, plan)[0]
            opt_g = optax.chain(capture(), joptim.clipped_adam(
                jpart.lr_tree_for(trainable, plan), cj.beta1,
                grad_clip=float("inf")))
            opt_d = optax.chain(capture(), joptim.adam(cj.lr_d, cj.beta1))
            g_apply = jbase.make_baseline_g_apply(tb.JAX[name][1],
                                                  jnp.asarray(z_init))
            d_apply = jnet.wdiscriminator_baselines_apply

            def fresh():
                """The step's state (the jitted steps donate theirs)."""
                return JState(g0, gs0, d0, ds0, opt_g.init(trainable),
                              opt_d.init(d0), jax.random.PRNGKey(3))

            rng = np.random.RandomState(5)
            batch = (rng.uniform(-1, 1, (2,) + tuple(_stage_thw(cj, SCALE))
                                 + (3,)).astype(np.float32),
                     rng.uniform(-1, 1, (2,) + tuple(_stage_thw(cj, 0))
                                 + (3,)).astype(np.float32),
                     tb._z(cj, 2, 6))
            real, real_zero, noise_init = (jnp.asarray(a) for a in batch)
            amps = jnp.asarray(tb.AMPS)
            d_draws = [_ncdhw(a) for a in tb._stage_draws(
                cj, name, k_fake, 2, n)] + [torch.tensor(float(
                    jax.random.uniform(k_alpha, ())))]
            g_draws = [_ncdhw(a) for a in tb._stage_draws(
                cj, name, k_fake2, 2, n)]

            results = {}
            for data_ranks in (1, 2):
                m = make_mesh(4, data_parallel=data_ranks)
                assert dict(m.shape) == {"data": data_ranks,
                                         "sp": 4 // data_ranks}
                mid, md_j = jsteps.make_d_step(cj, g_apply, d_apply, opt_d,
                                               mesh=m)(fresh(), real,
                                                       noise_init, amps)
                assert np.array_equal(np.asarray(mid.key), np.asarray(key_g))
                d_out = jax.tree_util.tree_map(np.asarray, (mid.opt_d[0],
                                                            mid.d_state))
                new, mg_j = jsteps.make_g_step(
                    cj, g_apply, d_apply, opt_g, plan, vae_phase=False,
                    mesh=m)(mid, real, real_zero, noise_init, amps)
                results[data_ranks] = dict(
                    md=md_j, mg=mg_j, d_grads=d_out[0], d_state=d_out[1],
                    g_grads=jax.tree_util.tree_map(np.asarray, new.opt_g[0]),
                    g_state=jax.tree_util.tree_map(np.asarray, new.g_state))

            G = tb._port_generator(ct, name, g0, gs0)
            D = WDiscriminatorBaselines(ct)
            D.load_state_dict(tb.from_jax_discriminator(d0, ds0, ndim=3))
            torch.save({"ct": ct, "g": G.state_dict(),
                        "z_init": _ncdhw(z_init), "d": D.state_dict(),
                        "plan": tpart.make_baseline_lr_plan(ct, SCALE, n,
                                                            **has),
                        "batch": [_ncdhw(a) for a in batch],
                        "amps": list(tb.AMPS), "d_draws": d_draws,
                        "g_draws": g_draws},
                       os.path.join(path, f"{name}.pt"))
            out[name] = dict(results=results, ct=ct, plan=plan,
                             init=(g0, gs0, d0, ds0))
    return out


def _check_step(outs, jax_steps, name, data_ranks):
    """(b)'s checks: every rank bit-equal, the metrics, gradients and
    states JAX's. Raises AssertionError on the first miss."""
    import test_torch_baselines as tb
    from test_torch_training import OP_TOL, assert_trees_close, port_grads

    from hpvaegan_tpu_torch.tools.convert import to_jax, to_jax_discriminator

    for out in outs[1:]:
        for part in ("d_grads", "d_sd", "g_grads", "g_sd"):
            for k, v in outs[0][part].items():
                assert torch.equal(v, out[part][k]), (part, k)
        assert outs[0]["d_metrics"] == out["d_metrics"]
        assert outs[0]["g_metrics"] == out["g_metrics"]
    r0, want = outs[0], jax_steps[name]["results"][data_ranks]
    ct, plan = jax_steps[name]["ct"], jax_steps[name]["plan"]
    g0, gs0, d0, ds0 = jax_steps[name]["init"]
    for got, ref in ((r0["d_metrics"], want["md"]),
                     (r0["g_metrics"], want["mg"])):
        tb._metrics_match(got, ref)
    D = WDiscriminatorBaselines(ct)
    D.load_state_dict(tb.from_jax_discriminator(d0, ds0, ndim=3))
    for k, q in D.named_parameters():
        q.grad = r0["d_grads"][k]
    assert_trees_close(port_grads(D, lambda sd: to_jax_discriminator(
        sd, ndim=3)), want["d_grads"], **OP_TOL)
    D.load_state_dict(r0["d_sd"])
    assert_trees_close(to_jax_discriminator(D.state_dict(), ndim=3)[1],
                       want["d_state"], **OP_TOL)
    G = tb._port_generator(ct, name, g0, gs0)
    for k, q in G.named_parameters():
        q.grad = r0["g_grads"].get(k)
    port = port_grads(G, lambda sd: to_jax(sd, ndim=3))
    assert sorted(want["g_grads"]["body"]) == [SCALE]
    for sub in ("head", "tail"):
        assert (sub in want["g_grads"]) == (plan.get(sub) is not None)
        if sub in want["g_grads"]:
            assert_trees_close(port[sub], want["g_grads"][sub], **OP_TOL)
    assert_trees_close(port["body"][SCALE], want["g_grads"]["body"][SCALE],
                       **OP_TOL)
    G.load_state_dict(r0["g_sd"])
    assert_trees_close(to_jax(G.state_dict(), ndim=3)[1], want["g_state"],
                       **OP_TOL)


@pytest.mark.parametrize("data_ranks", [1, 2])
@pytest.mark.parametrize("name", GENS)
def test_spatial_baseline_d_and_g_step_match_jax_mesh(jax_steps, name,
                                                      data_ranks):
    """A D step then a G step of a baseline on S = 4 (D = 1) and on D = 2 x
    S = 2 ranks equal JAX's jitted steps over a ('data', 'sp') mesh of the
    same shape at the same global batch of 2; each rank held its rows of H
    (real at 20 rows: 5 at S = 4; real_zero and noise_init at 12: 3)."""
    sp = 4 // data_ranks
    outs = run_ranks(__file__, "step", jax_steps["path"], name, data_ranks,
                     "none", world=4)
    b = 2 // data_ranks
    assert outs[0]["shapes"] == ((b, 3, 2, 20 // sp, 27),
                                 (b, 3, 2, 12 // sp, 17),
                                 (b, 3, 2, 12 // sp, 17))
    _check_step(outs, jax_steps, name, data_ranks)


@pytest.mark.parametrize("fault", FAULTS)
def test_spatial_baseline_planted_faults_are_caught(jax_steps, fault):
    """Each planted fault moves the S = 4 step of GeneratorCSG away from
    JAX's, and (b)'s checks fail on it; with the edge rows kept the edge
    ranks' stage outputs no longer fit their rows and the ranks fail."""
    args = (__file__, "step", jax_steps["path"], "GeneratorCSG", 1, fault)
    if fault == "edges_kept":
        with pytest.raises(AssertionError, match="failed"):
            run_ranks(*args, world=4)
        return
    outs = run_ranks(*args, world=4)
    with pytest.raises(AssertionError):
        _check_step(outs, jax_steps, "GeneratorCSG", 1)


CASES = {"primitives": _case_primitives, "step": _case_step}

if __name__ == "__main__":
    worker_main(CASES)
