"""Carry GeneratorHPVAEGAN / GeneratorVAE_nb and WDiscriminator2D / 3D
weights between the JAX package and the port.

The JAX package keeps a network as a (params, state) pytree of numpy arrays
with HWIO (2D) / DHWIO (3D) conv weights, pickled as netG_<k>.ckpt /
netD_<k>.ckpt. The port's state_dicts use the original hp-vae-gan torch
naming with OIHW / OIDHW weights:
  encode.features.conv_block_<i>.conv.{weight_orig,bias,weight_u,weight_v}
  encode.{mu,logvar}.conv.{weight,bias}   (+ encode.bern.conv.* for
                                          GeneratorVAE_nb)
  {decoder,body.<k>}.{head,block<i>}.{conv,norm}.*   {..}.tail.{weight,bias}
  (D) head.conv.*, body.block<i>.conv.* (SN convs), tail.{weight,bias}
`from_jax` is the port of the JAX package's `tools/convert.py::j2t_HPVAEGAN`
(`ndim` 2 or 3), `to_jax` of `p2j_HPVAEGAN` for the state_dicts `from_jax`
makes; `to_jax_discriminator` of `p2j_WDiscriminator` (`ndim` 2 or 3) and
`from_jax_discriminator` its inverse. Each checks the rank of the conv
weights against `ndim`. Spectral-norm v vectors are
re-permuted between torch's (I, [KD,] KH, KW) flattening and the JAX
package's ([KD,] KH, KW, I).
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _hwio_to_oihw(w) -> np.ndarray:
    """HWIO -> OIHW, and DHWIO -> OIDHW (`transpose(4, 3, 0, 1, 2)`)."""
    w = _f32(w)
    n = w.ndim
    return np.transpose(w, (n - 1, n - 2) + tuple(range(n - 2)))


def _oihw_to_hwio(w) -> np.ndarray:
    """OIHW -> HWIO, and OIDHW -> DHWIO."""
    w = _f32(w)
    return np.transpose(w, tuple(range(2, w.ndim)) + (1, 0))


def _v_perm(oihw_shape) -> np.ndarray:
    """perm[r] = torch's flat (I, *K) index of the JAX flat (*K, I) index r,
    for K = (KH, KW) or (KD, KH, KW)."""
    idx = np.arange(int(np.prod(oihw_shape[1:]))).reshape(oihw_shape[1:])
    return np.transpose(idx, tuple(range(1, idx.ndim)) + (0,)).reshape(-1)


def _check_rank(sd: Dict[str, np.ndarray], ndim: int) -> None:
    """Every conv weight must be (ndim + 2)-D: a 3D checkpoint read as 2D
    (or the reverse) fails here, not as a shape error deep in a forward."""
    ranks = {v.ndim for k, v in sd.items()
             if k.endswith(("conv.weight", "tail.weight", "weight_orig"))}
    if ranks != {ndim + 2}:
        raise ValueError(f"conv weights of rank {sorted(ranks)} in a {ndim}D "
                         f"network (want rank {ndim + 2})")


def _sn_from_jax(name: str, p: Dict, s: Dict, out: Dict) -> None:
    """One JAX {"snconv": {w, b}} / {"sn": {u, v}} pair -> `name`.* keys."""
    w = _hwio_to_oihw(p["snconv"]["w"])
    v = np.empty(w[0].size, np.float32)
    v[_v_perm(w.shape)] = _f32(s["sn"]["v"]).reshape(-1)
    out[f"{name}.weight_orig"] = w
    out[f"{name}.bias"] = _f32(p["snconv"]["b"])
    out[f"{name}.weight_u"] = _f32(s["sn"]["u"]).reshape(-1)
    out[f"{name}.weight_v"] = v


def _sn_to_jax(e: Dict[str, np.ndarray]) -> Tuple[Dict, Dict]:
    """{weight_orig, bias, weight_u, weight_v} -> the JAX (params, state)."""
    return ({"snconv": {"w": _oihw_to_hwio(e["weight_orig"]), "b": e["bias"]}},
            {"sn": {"u": e["weight_u"].reshape(-1),
                    "v": e["weight_v"].reshape(-1)[
                        _v_perm(e["weight_orig"].shape)]}})


def _numpy_sd(state_dict) -> Dict[str, np.ndarray]:
    return {k: _f32(v.detach().cpu().numpy() if torch.is_tensor(v) else v)
            for k, v in state_dict.items()}


def _stack_from_jax(prefix: str, p: Dict, s: Dict, out: Dict) -> None:
    for i, (bp, bs) in enumerate(zip(p["blocks"], s["blocks"])):
        name = f"{prefix}.{'head' if i == 0 else f'block{i - 1}'}"
        out[f"{name}.conv.weight"] = _hwio_to_oihw(bp["conv"]["w"])
        out[f"{name}.conv.bias"] = _f32(bp["conv"]["b"])
        out[f"{name}.norm.weight"] = _f32(bp["bn"]["gamma"])
        out[f"{name}.norm.bias"] = _f32(bp["bn"]["beta"])
        out[f"{name}.norm.running_mean"] = _f32(bs["bn"]["mean"])
        out[f"{name}.norm.running_var"] = _f32(bs["bn"]["var"])
    out[f"{prefix}.tail.weight"] = _hwio_to_oihw(p["tail"]["w"])
    out[f"{prefix}.tail.bias"] = _f32(p["tail"]["b"])


def from_jax(params: Dict, state: Dict, ndim: int = 2
             ) -> Dict[str, torch.Tensor]:
    """The JAX package's GeneratorHPVAEGAN or GeneratorVAE_nb (params,
    state), 2D or 3D per `ndim` -> the port's state_dict."""
    out: Dict[str, np.ndarray] = {}
    for i, (fp, fs) in enumerate(zip(params["encode"]["features"],
                                     state["encode"]["features"])):
        _sn_from_jax(f"encode.features.conv_block_{i}.conv", fp, fs, out)
    for head in ("mu", "logvar", "bern"):
        if head not in params["encode"]:
            continue
        out[f"encode.{head}.conv.weight"] = _hwio_to_oihw(
            params["encode"][head]["w"])
        out[f"encode.{head}.conv.bias"] = _f32(params["encode"][head]["b"])
    _stack_from_jax("decoder", params["decoder"], state["decoder"], out)
    for k, (sp, ss) in enumerate(zip(params["body"], state["body"])):
        _stack_from_jax(f"body.{k}", sp, ss, out)
    _check_rank(out, ndim)
    return {k: torch.tensor(v) for k, v in out.items()}  # copies


def _stack_to_jax(items: Dict[str, np.ndarray]) -> Tuple[Dict, Dict]:
    blocks_p: Dict[int, Dict] = {}
    blocks_s: Dict[int, Dict] = {}
    tail = {}
    for key, value in items.items():
        if key == "tail.weight":
            tail["w"] = _oihw_to_hwio(value)
            continue
        if key == "tail.bias":
            tail["b"] = value
            continue
        m = re.match(r"(head|block(\d+))\.(conv|norm)\.(\w+)$", key)
        if not m:
            raise KeyError(f"unexpected conv-stack key {key!r}")
        idx = 0 if m.group(1) == "head" else int(m.group(2)) + 1
        bp, bs = blocks_p.setdefault(idx, {}), blocks_s.setdefault(idx, {})
        mod, name = m.group(3), m.group(4)
        if mod == "conv":
            bp.setdefault("conv", {})["w" if name == "weight" else "b"] = (
                _oihw_to_hwio(value) if name == "weight" else value)
        elif name in ("weight", "bias"):
            bp.setdefault("bn", {})["gamma" if name == "weight" else "beta"] = value
        else:
            bs.setdefault("bn", {})["mean" if name == "running_mean"
                                    else "var"] = value
    n = len(blocks_p)
    return ({"blocks": [blocks_p[i] for i in range(n)], "tail": tail},
            {"blocks": [blocks_s[i] for i in range(n)]})


def to_jax(state_dict: Dict[str, torch.Tensor], ndim: int = 2
           ) -> Tuple[Dict, Dict]:
    """The port's GeneratorHPVAEGAN or GeneratorVAE_nb state_dict, 2D or
    3D per `ndim` -> the JAX package's (params, state) numpy pytree (what its netG_<k>.ckpt
    holds)."""
    sd = _numpy_sd(state_dict)
    _check_rank(sd, ndim)
    feats: Dict[int, Dict[str, np.ndarray]] = {}
    stacks: Dict[str, Dict[str, np.ndarray]] = {}
    enc_p: Dict = {}
    for key, value in sd.items():
        m = re.match(r"encode\.features\.conv_block_(\d+)\.conv\.(\w+)$", key)
        if m:
            feats.setdefault(int(m.group(1)), {})[m.group(2)] = value
            continue
        m = re.match(r"encode\.(mu|logvar|bern)\.conv\.(weight|bias)$", key)
        if m:
            w = _oihw_to_hwio(value) if m.group(2) == "weight" else value
            enc_p.setdefault(m.group(1), {})[
                "w" if m.group(2) == "weight" else "b"] = w
            continue
        m = re.match(r"(decoder|body\.\d+)\.(.*)$", key)
        if not m:
            raise KeyError(f"unexpected generator key {key!r}")
        stacks.setdefault(m.group(1), {})[m.group(2)] = value
    sn = [_sn_to_jax(feats[i]) for i in range(len(feats))]
    fp, fs = [p for p, _ in sn], [s for _, s in sn]
    dec_p, dec_s = _stack_to_jax(stacks.pop("decoder"))
    n_body = len(stacks)
    body = [_stack_to_jax(stacks[f"body.{k}"]) for k in range(n_body)]
    params = {"encode": {"features": fp, **enc_p}, "decoder": dec_p,
              "body": [p for p, _ in body]}
    state = {"encode": {"features": fs}, "decoder": dec_s,
             "body": [s for _, s in body]}
    return params, state


def from_jax_discriminator(params: Dict, state: Dict, ndim: int = 2
                           ) -> Dict[str, torch.Tensor]:
    """The JAX package's WDiscriminator2D / WDiscriminator3D (params,
    state), per `ndim` -> the port's state_dict."""
    out: Dict[str, np.ndarray] = {}
    _sn_from_jax("head.conv", params["head"], state["head"], out)
    for i, (bp, bs) in enumerate(zip(params["body"], state["body"])):
        _sn_from_jax(f"body.block{i}.conv", bp, bs, out)
    out["tail.weight"] = _hwio_to_oihw(params["tail"]["w"])
    out["tail.bias"] = _f32(params["tail"]["b"])
    _check_rank(out, ndim)
    return {k: torch.tensor(v) for k, v in out.items()}  # copies


def to_jax_discriminator(state_dict: Dict[str, torch.Tensor], ndim: int = 2
                         ) -> Tuple[Dict, Dict]:
    """The port's WDiscriminator2D / WDiscriminator3D state_dict, per `ndim`
    -> the JAX package's (params, state) numpy pytree (what its
    netD_<k>.ckpt holds)."""
    sd = _numpy_sd(state_dict)
    _check_rank(sd, ndim)
    head: Dict[str, np.ndarray] = {}
    body: Dict[int, Dict[str, np.ndarray]] = {}
    tail = {}
    for key, value in sd.items():
        m = re.match(r"(head|body\.block(\d+))\.conv\.(\w+)$", key)
        if m:
            entry = head if m.group(2) is None else \
                body.setdefault(int(m.group(2)), {})
            entry[m.group(3)] = value
        elif key in ("tail.weight", "tail.bias"):
            tail["w" if key == "tail.weight" else "b"] = (
                _oihw_to_hwio(value) if key == "tail.weight" else value)
        else:
            raise KeyError(f"unexpected discriminator key {key!r}")
    hp, hs = _sn_to_jax(head)
    blocks = [_sn_to_jax(body[i]) for i in range(len(body))]
    return ({"head": hp, "body": [p for p, _ in blocks], "tail": tail},
            {"head": hs, "body": [s for _, s in blocks]})
