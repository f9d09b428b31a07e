"""The spatial axis of the port's mesh (--mesh-sp, parallel/spatial.py) over
gloo ranks on the CPU, held against one process and against the JAX
package's ('data', 'sp') mesh.

  (a) The primitives at S = 2 (2 ranks) and at D = 2 x S = 2 (4 ranks),
      each rank on its rows of the batch and of H, against one process on
      the whole: a sharded conv2d and conv3d in forward, backward and the
      gradient penalty's double backward (each convolution on a rank ran
      on H / S + 2 rows); upscale_2d / upscale_3d across the four
      transitions (sharded or replicated in and out), bit for bit, and
      their backward; batch BatchNorm with groups 1 and 2 on a sharded and
      on a replicated activation, and its double backward; the sharded
      draws, and a bfloat16 halo and gather, bit for bit. Tolerances are
      the data axis's: rtol 1e-4 / atol 2e-5.
  (b) One GAN-scale D step, then one G step, at scale 3 of a pyramid whose
      heights 12, 15, 17, 20 mix sharded and replicated stages at S = 2
      (D and the encoder sharded), on S = 2 ranks and on D = 2 x S = 2
      ranks, with the JAX draws of one process replayed and cut to each
      rank's rows of B and H, against JAX `make_d_step` / `make_g_step`
      over `make_mesh(2, data_parallel=1)` and `make_mesh(4,
      data_parallel=2)` of the conftest's virtual devices: metrics rtol
      1e-4 / atol 1e-7, gradients and BatchNorm / spectral-norm state rtol
      1e-4 / atol 2e-5 (test_torch_data_parallel.py's); every rank's
      results bit-equal.
  (f) The planted faults that (b) must catch, each on S = 2 ranks: halo
      rows replaced by zeros, BatchNorm of a sharded activation not summed
      over the spatial ranks, and every spatial rank drawing the first rows
      of H.

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
from hpvaegan_tpu_torch.models import (get_discriminator,  # noqa: E402
                                       get_generator)
from hpvaegan_tpu_torch.ops import norm as tnorm  # noqa: E402
from hpvaegan_tpu_torch.ops.conv import conv  # noqa: E402
from hpvaegan_tpu_torch.ops.resize import upscale_2d, upscale_3d  # noqa: E402
from hpvaegan_tpu_torch.parallel import mesh, spatial  # noqa: E402
from hpvaegan_tpu_torch.training import partition as tpart  # noqa: E402
from hpvaegan_tpu_torch.training import steps as tsteps  # noqa: E402
from hpvaegan_tpu_torch.training.state import ScaleTrainState  # noqa: E402
from hpvaegan_tpu_torch.utils.noise import NoiseSource  # noqa: E402
from hpvaegan_tpu_torch.utils.pyramid import scale_size_2d  # noqa: E402

from test_torch_data_parallel import ShardedReplay, _rank_rows  # noqa: E402
from test_torch_multihost import run_ranks, worker_main  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=2e-5)
S = 2
# img 32, min 16, ar 0.75: heights 12 15 17 20 24, widths 17 20 23 27 33;
# at S = 2 the upscales run sharded->replicated, replicated->replicated,
# replicated->sharded and sharded->sharded
PYRAMID = dict(img_size=32, min_size=16, max_size=32)
AR = 0.75
VIDEO = dict(sampling_rates=[2, 1], org_fps=24.0, fps_lcm=2)


def _pyramid_cfg():
    cfg = tcfg.Config(**PYRAMID, **VIDEO).finalize()
    cfg.ar = AR
    return cfg


# ------------------------------------------------------- (a) primitives ---

def _problem(seed, *shape):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randn(*shape).astype(np.float32))


def _rows(t, data_ranks, data_rank, h):
    """Rows of data rank `data_rank` of `t`'s batch and, where the spatial
    axis splits `h` (t's axis -2), this rank's rows of it."""
    b = t.shape[0] // data_ranks
    t = t[data_rank * b:(data_rank + 1) * b]
    start, n = spatial.rows(h)
    return t.narrow(-2, start, n).contiguous()


def _conv_run(ndim, pick, sharded):
    """conv (padding 1) on `pick` of a fixed input, then a gradient-penalty-
    like loss: sum(q * (d sum(r * y) / dx)^2) + sum(r * y), differentiated
    again. Each rank's loss is its own elements' sum, so the ranks' sum is
    the global loss. In float64: a rank's weight gradient sums its rows'
    products in another order than one process's, and in float32 that
    order alone moves an entry that cancels to ~1e-3 of the largest by a
    few ulps of the largest, past TOL."""
    shape = (4, 3, 8, 6) if ndim == 2 else (4, 2, 3, 8, 5)

    def problem(seed, *shape):
        return _problem(seed, *shape).double()

    x = pick(problem(ndim, *shape)).requires_grad_(True)
    w = (problem(ndim + 1, 5, shape[1], *(3,) * ndim) * 0.3
         ).requires_grad_(True)
    b = problem(ndim + 2, 5).requires_grad_(True)
    out_shape = (shape[0], 5) + shape[2:]
    r, q = pick(problem(ndim + 3, *out_shape)), pick(problem(ndim + 4,
                                                             *shape))
    y = conv(x, w, b, padding=1, sharded=sharded)
    gx, = torch.autograd.grad((r * y).sum(), x, create_graph=True)
    loss = (q * gx ** 2).sum() + (r * y).sum()
    grads = torch.autograd.grad(loss, (x, w, b))
    return dict(y=y.detach(), gx=gx.detach(), x_grad=grads[0],
                w_grad=grads[1], b_grad=grads[2])


def _upscale_run(ndim, index, pick, h_in):
    """upscale_2d / upscale_3d from pyramid scale index - 1 to `index` on
    `pick` of a fixed input (h_in its global height), and the gradient of
    sum(r * y) with respect to the input. A rank weighs a replicated output
    by 1 / S, so that the ranks' losses sum to the global one, and sums a
    replicated input's gradient over the spatial axis (each rank's copy
    takes the terms of its own rows)."""
    cfg = _pyramid_cfg()
    h, w = scale_size_2d(index - 1, cfg.scale_factor, cfg.stop_scale,
                         cfg.img_size, cfg.ar)
    shape = (4, 3, h, w) if ndim == 2 else (4, 3, 2, h, w)
    x = pick(_problem(10 * index + ndim, *shape), h).requires_grad_(True)
    if ndim == 2:
        y = upscale_2d(x, index, cfg.scale_factor, cfg.stop_scale,
                       cfg.img_size, cfg.ar, h_in=h_in)
    else:
        y = upscale_3d(x, index, cfg.scale_factor, cfg.stop_scale,
                       cfg.img_size, cfg.stop_scale_time, cfg.sampling_rates,
                       cfg.org_fps, cfg.fps_lcm, cfg.ar, h_in=h_in)
    h_out = scale_size_2d(index, cfg.scale_factor, cfg.stop_scale,
                          cfg.img_size, cfg.ar)[0]
    whole = (4,) + tuple(y.shape[1:-2]) + (h_out, y.shape[-1])
    r = torch.cos(torch.arange(int(np.prod(whole)), dtype=torch.float32))
    weight = 1.0 if spatial.sharded(h_out) else 1.0 / spatial.axis().size
    x_grad, = torch.autograd.grad(
        (pick(r.reshape(whole), h_out) * y).sum() * weight, x)
    if not spatial.sharded(h_in):
        x_grad = spatial.sum_sp(x_grad)
    return dict(y=y.detach(), x_grad=x_grad)


def _bn_run(groups, h, pick, sharded):
    """Batch-mode BatchNorm of `pick` of a fixed (4 * groups, 3, h, 5)
    input, then sum(q * (d sum(r * y) / dx)^2) + sum(r * y^2),
    differentiated again; weighed and summed as in _upscale_run where h is
    not split."""
    shape = (4 * groups, 3, h, 5)
    x = (_problem(groups + h, *shape) * 2 + 0.5)
    gamma = (1 + 0.1 * _problem(1, 3)).requires_grad_(True)
    beta = (0.1 * _problem(2, 3)).requires_grad_(True)
    mean, var = 0.1 * _problem(3, 3), 1 + 0.2 * _problem(4, 3).abs()
    per = shape[0] // groups
    # the paired layout: `pick` of each group's rows
    x = torch.cat([pick(x[g * per:(g + 1) * per]) for g in range(groups)])
    x.requires_grad_(True)
    r = torch.cat([pick(_problem(5, *shape)[g * per:(g + 1) * per])
                   for g in range(groups)])
    q = torch.sin(r)
    y, m, v = tnorm.batchnorm(x, gamma, beta, mean, var, "batch",
                              groups=groups, sharded=sharded)
    gx, = torch.autograd.grad((r * y).sum(), x, create_graph=True)
    loss = (q * gx ** 2).sum() + (r * y ** 2).sum()
    if not sharded:
        loss = loss / spatial.axis().size
    grads = torch.autograd.grad(loss, (x, gamma, beta))
    x_grad = grads[0] if sharded else spatial.sum_sp(grads[0])
    return dict(y=y.detach(), mean=m, var=v, x_grad=x_grad,
                gamma_grad=grads[1], beta_grad=grads[2])


def _draws(b, h):
    """The draws of a (4, 3, h, 5) tensor, a gate and a (4,) flag vector,
    as the model asks for them: with this rank's shape (b rows of the
    batch) and the global h."""
    noise = NoiseSource(3, "cpu")
    n = spatial.local_h(h)
    return dict(normal=noise.draw_rows(h, "normal", (b, 3, n, 5)),
                grouped=noise.draw_rows(h, "grouped_normal", (2 * b, 3, n, 5),
                                        2),
                uniform=noise.draw_rows(h, "uniform", (b, 1, n, 5)),
                gate=noise.draw_rows(h, "bernoulli", (b, 1, n, 5)),
                flags=noise.bernoulli((b,)), alpha=noise.uniform())


def _primitives(data_ranks, data_rank):
    """Every primitive's results on this rank's rows (of B by the data axis,
    of H by the spatial axis in force; the whole of both in one
    process)."""
    def pick(h):
        return lambda t: _rows(t, data_ranks, data_rank, h)

    out = {}
    spatial.conv_rows.clear()
    for ndim in (2, 3):
        out[f"conv{ndim}"] = _conv_run(ndim, pick(8), spatial.sharded(8))
    out["conv_rows"] = dict(spatial.conv_rows)
    cfg = _pyramid_cfg()
    for ndim in (2, 3):
        for index in range(1, cfg.stop_scale + 1):
            h_in = scale_size_2d(index - 1, cfg.scale_factor, cfg.stop_scale,
                                 cfg.img_size, cfg.ar)[0]
            out[f"up{ndim}_{index}"] = _upscale_run(
                ndim, index, lambda t, h: pick(h)(t), h_in)
    for groups in (1, 2):
        for h in (8, 7):  # split at S = 2, and whole on every rank
            out[f"bn{groups}_{h}"] = _bn_run(groups, h, pick(h),
                                             spatial.sharded(h))
    for h in (8, 7):
        out[f"draws_{h}"] = _draws(4 // data_ranks, h)
    return out


def _want_rows(v, data_ranks, d, s, groups=1):
    """Rank (d, s)'s rows of one process's `v`: of each of `groups` equal
    parts of the batch, and of H where it divides by S."""
    per = v.shape[0] // groups
    b = per // data_ranks
    v = torch.cat([v[g * per + d * b:g * per + (d + 1) * b]
                   for g in range(groups)])
    if v.ndim < 4 or v.shape[-2] % S:
        return v
    n = v.shape[-2] // S
    return v.narrow(-2, n * s, n)


PARAM_GRADS = ("w_grad", "b_grad", "gamma_grad", "beta_grad")


def _case_primitives(rank, world, out_dir, data_ranks):
    data_ranks = int(data_ranks)
    group = mesh.make_data_group(data_ranks, world // data_ranks)
    with mesh.data_parallel(group):
        out = _primitives(data_ranks, group.rank)
        # each rank's loss is its own terms' sum: the parameters' gradient
        # is the sum over all ranks
        with torch.no_grad():
            for res in out.values():
                for k in PARAM_GRADS:
                    if isinstance(res, dict) and k in res:
                        res[k] = mesh.sum_all(res[k])
        out["place"] = (group.rank, group.size, group.sp.rank, group.sp.size,
                        [spatial.rows(h) for h in (8, 7, 12, 20)])
        # bfloat16 (--compute-dtype) crosses the exchanges as its bytes
        x = _rows(_problem(9, 4, 3, 8, 5).bfloat16(), data_ranks,
                  group.rank, 8)
        out["bf16"] = dict(halo=spatial.halo(x, 1),
                           gathered=spatial.gather_rows(x, 8))
    return out


@pytest.mark.parametrize("data_ranks", [1, 2])
def test_spatial_primitives_equal_one_process(tmp_path, data_ranks):
    """Each rank's convolutions (with the GP's double backward), upscales,
    BatchNorm and draws on its rows equal one process's rows of the whole;
    the parameters' gradients summed over the ranks equal one process's."""
    world = data_ranks * S
    want = _primitives(1, 0)
    outs = run_ranks(__file__, "primitives", tmp_path, data_ranks,
                     world=world)
    for r, out in enumerate(outs):
        d, s = divmod(r, S)
        assert out["place"][:4] == (d, data_ranks, s, S)
        assert out["place"][4] == [(4 * s, 4), (0, 7), (6 * s, 6),
                                   (10 * s, 10)]
        # the conv2d and the conv3d each ran once, on the rank's 4 rows of
        # 8 and one halo row on each side, never on the whole height
        assert out["conv_rows"] == {6: 2}, out["conv_rows"]
        b = 4 // data_ranks
        x = _problem(9, 4, 3, 8, 5).bfloat16()[d * b:(d + 1) * b]
        padded = torch.nn.functional.pad(x, (0, 0, 1, 1))
        assert torch.equal(out["bf16"]["halo"],
                           padded[..., 4 * s:4 * s + 6, :])
        assert torch.equal(out["bf16"]["gathered"], x)
        for key, res in want.items():
            if key == "conv_rows":
                continue
            got = out[key]
            for k, v in res.items():
                if k in ("mean", "var", "alpha") or k in PARAM_GRADS:
                    torch.testing.assert_close(got[k], v, **TOL,
                                               msg=f"{key} {k}")
                    torch.testing.assert_close(got[k], outs[0][key][k],
                                               rtol=0, atol=0)
                    continue
                groups = 2 if key.startswith("bn2") or k == "grouped" else 1
                want_rows = _want_rows(v, data_ranks, d, s, groups)
                if key.startswith(("up", "draws")) and k != "x_grad":
                    # the same gathers and lerps, the same draws: bit-equal
                    assert torch.equal(got[k], want_rows), f"{key} {k}"
                else:
                    torch.testing.assert_close(got[k], want_rows, **TOL,
                                               msg=f"{key} {k}")


# --------------------------------------------- (b) one D + G step vs JAX ---

SCALE = 3  # heights 12 15 17 20: the encoder, decoder and D sharded at S = 2
FAULTS = ("halo_zeros", "bn_not_summed_over_sp", "draws_first_rows")


def _plant(fault):
    """Break one exchange in this process, as `fault` names it."""
    if fault == "halo_zeros":
        spatial._neighbour_rows = lambda top, bottom, ax: (
            torch.zeros_like(bottom), torch.zeros_like(top))
    elif fault == "bn_not_summed_over_sp":
        tnorm.set_sharded_sum = lambda sharded_sum: None
    elif fault == "draws_first_rows":
        def first_rows(self, h, kind, shape, *args):
            draw = getattr(self, kind)
            if not spatial.sharded(h):
                return draw(shape, *args)
            shape = tuple(shape)
            whole = draw(shape[:-2] + (h, shape[-1]), *args)
            return whole.narrow(-2, 0, shape[-2])

        NoiseSource.draw_rows = first_rows
    elif fault != "none":
        raise ValueError(fault)


def _case_step(rank, world, out_dir, data_ranks, fault):
    """This rank's rows of the batch (of B by the data axis, of H where the
    spatial axis splits it), the D step then the G step; the metrics,
    gradients and states."""
    _plant(fault)
    data_ranks = int(data_ranks)
    p = torch.load(os.path.join(out_dir, "step_in.pt"), weights_only=False)
    ct = p["ct"]
    G = get_generator(ct.generator)(ct)
    for _ in range(p["n_body"]):
        G.init_next_stage()
    G.load_state_dict(p["g"])
    D = get_discriminator(ct.discriminator)(ct)
    D.load_state_dict(p["d"])
    group = mesh.make_data_group(data_ranks, world // data_ranks)
    st = ScaleTrainState(
        G, D, toptim.ClippedAdam(tpart.apply_lr_plan(G, p["plan"]), ct.beta1,
                                 grad_clip=ct.grad_clip),
        toptim.adam(D.parameters(), ct.lr_d, ct.beta1), None)
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
    out["shapes"] = (tuple(real.shape), tuple(real_zero.shape))
    return out


@pytest.fixture(scope="module")
def jax_steps(tmp_path_factory):
    """The step's payload for the ranks (weights, batch, the JAX draws of
    one process) and JAX's D and G steps over both meshes."""
    import jax
    import jax.numpy as jnp
    import optax

    from hpvaegan_tpu import optim as joptim
    from hpvaegan_tpu.models import networks_2d as jnet
    from hpvaegan_tpu.parallel.mesh import make_mesh
    from hpvaegan_tpu.training import partition as jpart
    from hpvaegan_tpu.training import steps as jsteps
    from hpvaegan_tpu.training.state import ScaleTrainState as JState

    import test_torch_trainer as t2
    from test_torch_training import (cfgs, jax_discriminator, jax_generator,
                                     nchw, port_generator)

    drawn = []
    orig = jnet.generate_noise

    def record(key, shape, kind="normal", dtype=jnp.float32):
        out = orig(key, shape, kind, dtype)
        drawn.append((kind, out))
        return out

    def capture():
        """An optax stage that keeps the gradients it is given in its
        state: the jitted steps' gradients, read from their output."""
        return optax.GradientTransformation(
            lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
            lambda updates, state, params=None: (updates, updates))

    cj, ct = cfgs()
    for c in (cj, ct):
        c.ar, c.scale_idx = AR, SCALE
    heights = [scale_size_2d(i, ct.scale_factor, ct.stop_scale, ct.img_size,
                             AR) for i in range(SCALE + 1)]
    assert [h for h, _ in heights] == [12, 15, 17, 20]
    g0, gs0 = jax_generator(cj, SCALE, seed=0)
    d0, ds0 = jax_discriminator(cj, seed=7)
    g0, gs0 = jax.tree_util.tree_map(np.asarray, (g0, gs0))
    plan = jpart.make_lr_plan(cj, SCALE, SCALE)
    trainable = jpart.split_params(g0, plan)[0]
    opt_g = optax.chain(capture(), joptim.clipped_adam(
        jpart.lr_tree_for(trainable, plan), cj.beta1,
        grad_clip=cj.grad_clip))
    opt_d = optax.chain(capture(), joptim.adam(cj.lr_d, cj.beta1))

    def fresh():
        """The step's state (the jitted steps donate theirs)."""
        return JState(g0, gs0, d0, ds0, opt_g.init(trainable),
                      opt_d.init(d0), jax.random.PRNGKey(3))

    jst = fresh()
    rng = np.random.RandomState(5)
    (h, w), (h0, w0) = heights[SCALE], heights[0]
    batch = (rng.uniform(-1, 1, (2, h, w, 3)).astype(np.float32),
             rng.uniform(-1, 1, (2, h0, w0, 3)).astype(np.float32),
             rng.randn(2, h0, w0, cj.latent_dim).astype(np.float32))
    real, real_zero, noise_init = (jnp.asarray(a) for a in batch)
    amps = jnp.asarray(t2.AMPS)
    g_apply, d_apply = (jnet.generator_hpvaegan_apply,
                        jnet.wdiscriminator2d_apply)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnet, "generate_noise", record)
        # the draws, from the unjitted cores (the jitted steps' keys)
        mid_core, _ = jsteps._d_step_core(cj, g_apply, d_apply, opt_d, None)(
            jst, real, noise_init, amps)
        d_draws = [(k, np.asarray(a)) for k, a in drawn]
        d_draws.append(("uniform", np.asarray(jax.random.uniform(
            jax.random.split(jst.key, 3)[2], ()))))
        drawn.clear()
        jsteps._g_step_core(cj, g_apply, d_apply, opt_g, plan,
                            vae_phase=False, cd=None)(
            mid_core, real, real_zero, noise_init, amps)
        g_draws = [(k, np.asarray(a)) for k, a in drawn]
    assert [k for k, _ in d_draws] == ["normal"] * 3 + ["uniform"]
    assert [k for k, _ in g_draws] == ["normal"] * 4

    results = {}
    for data_ranks in (1, 2):
        m = make_mesh(data_ranks * S, data_parallel=data_ranks)
        assert dict(m.shape) == {"data": data_ranks, "sp": S}
        mid, md_j = jsteps.make_d_step(cj, g_apply, d_apply, opt_d, mesh=m)(
            fresh(), real, noise_init, amps)
        d_out = jax.tree_util.tree_map(np.asarray, (mid.opt_d[0],
                                                    mid.d_state))
        new, mg_j = jsteps.make_g_step(cj, g_apply, d_apply, opt_g, plan,
                                       vae_phase=False, mesh=m)(
            mid, real, real_zero, noise_init, amps)
        results[data_ranks] = dict(
            md=md_j, mg=mg_j, d_grads=d_out[0], d_state=d_out[1],
            g_grads=jax.tree_util.tree_map(np.asarray, new.opt_g[0]),
            g_state=jax.tree_util.tree_map(np.asarray, new.g_state))

    def nchw_draws(draws):
        return [torch.from_numpy(np.asarray(a).copy()) if a.ndim == 0
                else nchw(a) for _, a in draws]

    G = port_generator(ct, g0, gs0)
    path = tmp_path_factory.mktemp("spatial_step")
    from test_torch_training import port_discriminator
    torch.save({"ct": ct, "plan": plan, "n_body": len(G.body),
                "g": G.state_dict(),
                "d": port_discriminator(ct, d0, ds0).state_dict(),
                "batch": [nchw(a) for a in batch], "amps": list(t2.AMPS),
                "d_draws": nchw_draws(d_draws),
                "g_draws": nchw_draws(g_draws)},
               os.path.join(path, "step_in.pt"))
    return dict(path=path, results=results, ct=ct, plan=plan,
                init=(g0, gs0, d0, ds0))


def _check_step(outs, jax_steps, data_ranks):
    """(b)'s checks: every rank bit-equal, the metrics, gradients and
    states JAX's. Raises AssertionError on the first miss."""
    import test_torch_trainer as t2
    from test_torch_training import (OP_TOL, assert_trees_close,
                                     port_discriminator, port_generator,
                                     port_grads)

    from hpvaegan_tpu_torch.tools.convert import to_jax, to_jax_discriminator

    for out in outs[1:]:
        for part in ("d_grads", "d_sd", "g_grads", "g_sd"):
            for k, v in outs[0][part].items():
                assert torch.equal(v, out[part][k]), (part, k)
        assert outs[0]["d_metrics"] == out["d_metrics"]
        assert outs[0]["g_metrics"] == out["g_metrics"]
    r0, want = outs[0], jax_steps["results"][data_ranks]
    ct, plan = jax_steps["ct"], jax_steps["plan"]
    g0, gs0, d0, ds0 = jax_steps["init"]
    for got, ref in ((r0["d_metrics"], want["md"]),
                     (r0["g_metrics"], want["mg"])):
        t2._metrics_match({k: torch.tensor(v) for k, v in got.items()}, ref)
    D = port_discriminator(ct, d0, ds0)
    for k, q in D.named_parameters():
        q.grad = r0["d_grads"][k]
    assert_trees_close(port_grads(D, to_jax_discriminator), want["d_grads"],
                       **OP_TOL)
    D.load_state_dict(r0["d_sd"])
    assert_trees_close(to_jax_discriminator(D.state_dict())[1],
                       want["d_state"], **OP_TOL)
    G = port_generator(ct, g0, gs0)
    for k, q in G.named_parameters():
        q.grad = r0["g_grads"].get(k)
        q.requires_grad_(k in r0["g_grads"])
    t2._g_grads_match(G, plan, want["g_grads"], ct.grad_clip)
    G.load_state_dict(r0["g_sd"])
    assert_trees_close(to_jax(G.state_dict())[1], want["g_state"], **OP_TOL)


@pytest.mark.parametrize("data_ranks", [1, 2])
def test_spatial_d_and_g_step_match_jax_mesh(jax_steps, data_ranks):
    """A GAN-scale D step then G step on S = 2 (and D = 2 x S = 2) ranks
    equal JAX's jitted steps over a ('data', 'sp') mesh of the same shape at
    the same global batch of 2; each rank held its rows of H where the
    scale's height divides by 2 (real at 20 rows: 10; real_zero and
    noise_init at 12: 6)."""
    outs = run_ranks(__file__, "step", jax_steps["path"], data_ranks, "none",
                     world=data_ranks * S)
    b = 2 // data_ranks
    assert outs[0]["shapes"] == ((b, 3, 10, 27), (b, 3, 6, 17))
    _check_step(outs, jax_steps, data_ranks)


@pytest.mark.parametrize("fault", FAULTS)
def test_spatial_planted_faults_are_caught(jax_steps, fault):
    """Each planted fault moves the S = 2 step away from JAX's: (b)'s
    checks fail on it."""
    outs = run_ranks(__file__, "step", jax_steps["path"], 1, fault,
                     world=S)
    with pytest.raises(AssertionError):
        _check_step(outs, jax_steps, 1)


CASES = {"primitives": _case_primitives, "step": _case_step}

if __name__ == "__main__":
    worker_main(CASES)
