"""Carry GeneratorHPVAEGAN / GeneratorVAE_nb, GeneratorCSG / GeneratorSG and
WDiscriminator2D / 3D / Baselines weights between the JAX package and the
port.

The JAX package keeps a network as a (params, state) pytree of numpy arrays
with HWIO (2D) / DHWIO (3D) conv weights, pickled as netG_<k>.ckpt /
netD_<k>.ckpt. The port's state_dicts use the original hp-vae-gan torch
naming with OIHW / OIDHW weights:
  encode.features.conv_block_<i>.conv.{weight_orig,bias,weight_u,weight_v}
  encode.{mu,logvar}.conv.{weight,bias}   (+ encode.bern.conv.* for
                                          GeneratorVAE_nb)
  {decoder,body.<k>}.{head,block<i>}.{conv,norm}.*   {..}.tail.{weight,bias}
  (baselines) head.{conv,norm}.*, body.<k>.blocks.<i>.{conv,norm}.*,
              body.<k>.tail.weight[,bias], tail.{weight,bias} (CSG has the
              head and the outer tail, SG the stage tails, without bias)
  (D) head.conv.*, body.block<i>.conv.* (SN convs), tail.{weight,bias};
      WDiscriminatorBaselines' head.conv is a plain conv
`from_jax` is the port of the JAX package's `tools/convert.py::j2t_HPVAEGAN`
(`ndim` 2 or 3), `to_jax` of `p2j_HPVAEGAN` for the state_dicts `from_jax`
makes; both also carry the baselines' trees (JAX networks_3d.py:347-480),
which the JAX package has no converter for. `to_jax_discriminator` is the
port of `p2j_WDiscriminator` (`ndim` 2 or 3) and `from_jax_discriminator`
its inverse. Each checks the rank of the conv weights against `ndim`.
Spectral-norm v vectors are re-permuted between torch's (I, [KD,] KH, KW)
flattening and the JAX package's ([KD,] KH, KW, I).
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


def _conv_from_jax(name: str, p: Dict, out: Dict) -> None:
    """A JAX {w[, b]} conv -> `name`.weight[, `name`.bias]."""
    out[f"{name}.weight"] = _hwio_to_oihw(p["w"])
    if "b" in p:
        out[f"{name}.bias"] = _f32(p["b"])


def _block_from_jax(name: str, bp: Dict, bs: Dict, out: Dict) -> None:
    """A JAX ConvBlock ({conv, bn} params, {bn} state) -> `name`.*."""
    _conv_from_jax(f"{name}.conv", bp["conv"], out)
    out[f"{name}.norm.weight"] = _f32(bp["bn"]["gamma"])
    out[f"{name}.norm.bias"] = _f32(bp["bn"]["beta"])
    out[f"{name}.norm.running_mean"] = _f32(bs["bn"]["mean"])
    out[f"{name}.norm.running_var"] = _f32(bs["bn"]["var"])


def _stack_from_jax(prefix: str, p: Dict, s: Dict, out: Dict) -> None:
    for i, (bp, bs) in enumerate(zip(p["blocks"], s["blocks"])):
        _block_from_jax(f"{prefix}.{'head' if i == 0 else f'block{i - 1}'}",
                        bp, bs, out)
    _conv_from_jax(f"{prefix}.tail", p["tail"], out)


def _baseline_from_jax(params: Dict, state: Dict, out: Dict) -> None:
    """GeneratorCSG ({head, body, tail}) or GeneratorSG ({body}) -> the
    port's keys."""
    if "head" in params:
        _block_from_jax("head", params["head"], state["head"], out)
    for k, (sp, ss) in enumerate(zip(params["body"], state["body"])):
        for i, (bp, bs) in enumerate(zip(sp["blocks"], ss["blocks"])):
            _block_from_jax(f"body.{k}.blocks.{i}", bp, bs, out)
        if "tail" in sp:
            _conv_from_jax(f"body.{k}.tail", sp["tail"], out)
    if "tail" in params:
        _conv_from_jax("tail", params["tail"], out)


def from_jax(params: Dict, state: Dict, ndim: int = 2
             ) -> Dict[str, torch.Tensor]:
    """The JAX package's GeneratorHPVAEGAN or GeneratorVAE_nb (params,
    state), 2D or 3D per `ndim`, or its GeneratorCSG / GeneratorSG (a tree
    without "encode") -> the port's state_dict."""
    out: Dict[str, np.ndarray] = {}
    if "encode" not in params:
        _baseline_from_jax(params, state, out)
        _check_rank(out, ndim)
        return {k: torch.tensor(v) for k, v in out.items()}  # copies
    for i, (fp, fs) in enumerate(zip(params["encode"]["features"],
                                     state["encode"]["features"])):
        _sn_from_jax(f"encode.features.conv_block_{i}.conv", fp, fs, out)
    for head in ("mu", "logvar", "bern"):
        if head not in params["encode"]:
            continue
        _conv_from_jax(f"encode.{head}.conv", params["encode"][head], out)
    _stack_from_jax("decoder", params["decoder"], state["decoder"], out)
    for k, (sp, ss) in enumerate(zip(params["body"], state["body"])):
        _stack_from_jax(f"body.{k}", sp, ss, out)
    _check_rank(out, ndim)
    return {k: torch.tensor(v) for k, v in out.items()}  # copies


def _groups(items: Dict[str, np.ndarray], pattern: str, what: str
            ) -> Dict[str, Dict[str, np.ndarray]]:
    """{group: {rest: value}} of the keys `pattern` splits into (group,
    rest); any other key is an error."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for key, value in items.items():
        m = re.match(pattern, key)
        if not m:
            raise KeyError(f"unexpected {what} key {key!r}")
        out.setdefault(m.group(1), {})[m.group(2)] = value
    return out


def _conv_to_jax(e: Dict[str, np.ndarray]) -> Dict:
    """{weight[, bias]} -> the JAX {w[, b]}."""
    out = {"w": _oihw_to_hwio(e["weight"])}
    if "bias" in e:
        out["b"] = e["bias"]
    return out


def _block_to_jax(e: Dict[str, np.ndarray]) -> Tuple[Dict, Dict]:
    """{conv.*, norm.*} -> a JAX ConvBlock's (params, state)."""
    return ({"conv": _conv_to_jax({"weight": e["conv.weight"],
                                   "bias": e["conv.bias"]}),
             "bn": {"gamma": e["norm.weight"], "beta": e["norm.bias"]}},
            {"bn": {"mean": e["norm.running_mean"],
                    "var": e["norm.running_var"]}})


def _stack_to_jax(items: Dict[str, np.ndarray]) -> Tuple[Dict, Dict]:
    groups = _groups(items, r"(head|block\d+|tail)\.(.+)$", "conv-stack")
    names = ["head"] + [f"block{i}" for i in range(len(groups) - 2)]
    blocks = [_block_to_jax(groups[n]) for n in names]
    return ({"blocks": [p for p, _ in blocks],
             "tail": _conv_to_jax(groups["tail"])},
            {"blocks": [s for _, s in blocks]})


def _baseline_to_jax(sd: Dict[str, np.ndarray]) -> Tuple[Dict, Dict]:
    """GeneratorCSG / GeneratorSG keys -> the JAX package's tree."""
    groups = _groups(sd, r"(head|tail|body\.\d+)\.(.+)$", "baseline")
    params: Dict = {}
    state: Dict = {}
    if "head" in groups:
        params["head"], state["head"] = _block_to_jax(groups["head"])
    params["body"], state["body"] = [], []
    for k in range(sum(g.startswith("body.") for g in groups)):
        stage = _groups(groups[f"body.{k}"], r"(blocks\.\d+|tail)\.(.+)$",
                        "baseline stage")
        n = len(stage) - ("tail" in stage)
        blocks = [_block_to_jax(stage[f"blocks.{i}"]) for i in range(n)]
        params["body"].append({"blocks": [p for p, _ in blocks]})
        state["body"].append({"blocks": [s for _, s in blocks]})
        if "tail" in stage:
            params["body"][-1]["tail"] = _conv_to_jax(stage["tail"])
    if "tail" in groups:
        params["tail"] = _conv_to_jax(groups["tail"])
    return params, state


def to_jax(state_dict: Dict[str, torch.Tensor], ndim: int = 2
           ) -> Tuple[Dict, Dict]:
    """The port's GeneratorHPVAEGAN, GeneratorVAE_nb (2D or 3D per `ndim`),
    GeneratorCSG or GeneratorSG state_dict -> the JAX package's (params,
    state) numpy pytree (what its netG_<k>.ckpt holds)."""
    sd = _numpy_sd(state_dict)
    _check_rank(sd, ndim)
    if not any(key.startswith("encode.") for key in sd):
        return _baseline_to_jax(sd)
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
            enc_p.setdefault(m.group(1), {})[m.group(2)] = value
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
    params = {"encode": {"features": fp, **{k: _conv_to_jax(e) for k, e in
                                            enc_p.items()}},
              "decoder": dec_p, "body": [p for p, _ in body]}
    state = {"encode": {"features": fs}, "decoder": dec_s,
             "body": [s for _, s in body]}
    return params, state


def from_jax_discriminator(params: Dict, state: Dict, ndim: int = 2
                           ) -> Dict[str, torch.Tensor]:
    """The JAX package's WDiscriminator2D / WDiscriminator3D /
    WDiscriminatorBaselines (params, state), per `ndim` -> the port's
    state_dict. The baselines' head is a plain conv: no SN, no state."""
    out: Dict[str, np.ndarray] = {}
    if "snconv" in params["head"]:
        _sn_from_jax("head.conv", params["head"], state["head"], out)
    else:
        _conv_from_jax("head.conv", params["head"]["conv"], out)
    for i, (bp, bs) in enumerate(zip(params["body"], state["body"])):
        _sn_from_jax(f"body.block{i}.conv", bp, bs, out)
    _conv_from_jax("tail", params["tail"], out)
    _check_rank(out, ndim)
    return {k: torch.tensor(v) for k, v in out.items()}  # copies


def to_jax_discriminator(state_dict: Dict[str, torch.Tensor], ndim: int = 2
                         ) -> Tuple[Dict, Dict]:
    """The port's WDiscriminator2D / WDiscriminator3D /
    WDiscriminatorBaselines state_dict, per `ndim` -> the JAX package's
    (params, state) numpy pytree (what its netD_<k>.ckpt holds)."""
    sd = _numpy_sd(state_dict)
    _check_rank(sd, ndim)
    groups = _groups(sd, r"(head\.conv|body\.block\d+\.conv|tail)\.(\w+)$",
                     "discriminator")
    head = groups.pop("head.conv")
    tail = groups.pop("tail")
    hp, hs = _sn_to_jax(head) if "weight_orig" in head else \
        ({"conv": _conv_to_jax(head)}, {})
    blocks = [_sn_to_jax(groups[f"body.block{i}.conv"])
              for i in range(len(groups))]
    return ({"head": hp, "body": [p for p, _ in blocks],
             "tail": _conv_to_jax(tail)},
            {"head": hs, "body": [s for _, s in blocks]})
