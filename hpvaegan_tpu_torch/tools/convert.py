"""Carry GeneratorHPVAEGAN weights between the JAX package and the port.

The JAX package keeps a generator as a (params, state) pytree of numpy
arrays with HWIO conv weights, pickled as netG_<k>.ckpt. The port's
state_dict uses the original hp-vae-gan torch naming with OIHW weights:
  encode.features.conv_block_<i>.conv.{weight_orig,bias,weight_u,weight_v}
  encode.{mu,logvar}.conv.{weight,bias}
  {decoder,body.<k>}.{head,block<i>}.{conv,norm}.*   {..}.tail.{weight,bias}
`from_jax` is the port of the JAX package's `tools/convert.py::j2t_HPVAEGAN`
(2D), `to_jax` of `p2j_HPVAEGAN` (2D) for the state_dicts `from_jax`
makes. Spectral-norm v vectors are re-permuted between torch's (I, KH, KW)
flattening and the JAX package's (KH, KW, I).
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _hwio_to_oihw(w) -> np.ndarray:
    return np.transpose(_f32(w), (3, 2, 0, 1))


def _oihw_to_hwio(w) -> np.ndarray:
    return np.transpose(_f32(w), (2, 3, 1, 0))


def _v_perm(oihw_shape) -> np.ndarray:
    """perm[r] = torch's flat (I, KH, KW) index of the JAX flat (KH, KW, I)
    index r."""
    _, i, kh, kw = oihw_shape
    idx = np.arange(i * kh * kw).reshape(i, kh, kw)
    return np.transpose(idx, (1, 2, 0)).reshape(-1)


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


def from_jax(params: Dict, state: Dict) -> Dict[str, torch.Tensor]:
    """The JAX package's GeneratorHPVAEGAN (params, state) -> the port's
    state_dict."""
    out: Dict[str, np.ndarray] = {}
    for i, (fp, fs) in enumerate(zip(params["encode"]["features"],
                                     state["encode"]["features"])):
        name = f"encode.features.conv_block_{i}.conv"
        w = _hwio_to_oihw(fp["snconv"]["w"])
        v = np.empty(w[0].size, np.float32)
        v[_v_perm(w.shape)] = _f32(fs["sn"]["v"]).reshape(-1)
        out[f"{name}.weight_orig"] = w
        out[f"{name}.bias"] = _f32(fp["snconv"]["b"])
        out[f"{name}.weight_u"] = _f32(fs["sn"]["u"]).reshape(-1)
        out[f"{name}.weight_v"] = v
    for head in ("mu", "logvar"):
        out[f"encode.{head}.conv.weight"] = _hwio_to_oihw(
            params["encode"][head]["w"])
        out[f"encode.{head}.conv.bias"] = _f32(params["encode"][head]["b"])
    _stack_from_jax("decoder", params["decoder"], state["decoder"], out)
    for k, (sp, ss) in enumerate(zip(params["body"], state["body"])):
        _stack_from_jax(f"body.{k}", sp, ss, out)
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


def to_jax(state_dict: Dict[str, torch.Tensor]) -> Tuple[Dict, Dict]:
    """The port's GeneratorHPVAEGAN state_dict -> the JAX package's
    (params, state) numpy pytree (what its netG_<k>.ckpt holds)."""
    sd = {k: _f32(v.detach().cpu().numpy() if torch.is_tensor(v) else v)
          for k, v in state_dict.items()}
    feats: Dict[int, Dict[str, np.ndarray]] = {}
    stacks: Dict[str, Dict[str, np.ndarray]] = {}
    enc_p: Dict = {}
    for key, value in sd.items():
        m = re.match(r"encode\.features\.conv_block_(\d+)\.conv\.(\w+)$", key)
        if m:
            feats.setdefault(int(m.group(1)), {})[m.group(2)] = value
            continue
        m = re.match(r"encode\.(mu|logvar)\.conv\.(weight|bias)$", key)
        if m:
            w = _oihw_to_hwio(value) if m.group(2) == "weight" else value
            enc_p.setdefault(m.group(1), {})[
                "w" if m.group(2) == "weight" else "b"] = w
            continue
        m = re.match(r"(decoder|body\.\d+)\.(.*)$", key)
        if not m:
            raise KeyError(f"unexpected generator key {key!r}")
        stacks.setdefault(m.group(1), {})[m.group(2)] = value
    fp, fs = [], []
    for i in range(len(feats)):
        e = feats[i]
        fp.append({"snconv": {"w": _oihw_to_hwio(e["weight_orig"]),
                              "b": e["bias"]}})
        fs.append({"sn": {"u": e["weight_u"].reshape(-1),
                          "v": e["weight_v"].reshape(-1)[
                              _v_perm(e["weight_orig"].shape)]}})
    dec_p, dec_s = _stack_to_jax(stacks.pop("decoder"))
    n_body = len(stacks)
    body = [_stack_to_jax(stacks[f"body.{k}"]) for k in range(n_body)]
    params = {"encode": {"features": fp, **enc_p}, "decoder": dec_p,
              "body": [p for p, _ in body]}
    state = {"encode": {"features": fs}, "decoder": dec_s,
             "body": [s for _, s in body]}
    return params, state
