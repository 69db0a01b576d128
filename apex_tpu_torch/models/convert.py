"""GPT-2, BERT, ResNet and GroupNorm-model parameters for the port: from a
flax tree and back, or made from a seed.

The port's parameter dict (``GPT2.state_dict()`` names) mirrors the flax
tree of ``apex_tpu.models.gpt2.GPT2.init``:

- ``wte (vocab, e)``, ``wpe (n_positions, e)``, ``ln_f.{weight,bias}``;
- per layer ``h.{i}.``: ``ln_1`` / ``ln_2`` ``{weight,bias}``,
  ``attn_qkv`` / ``attn_out`` ``{weight,bias}`` and
  ``mlp_fc_w (4e, e)``, ``mlp_fc_b``, ``mlp_proj_w (e, 4e)``,
  ``mlp_proj_b``.

Layouts: a flax ``nn.Dense`` kernel is ``(in, out)``; the port stores
dense weights PyTorch's way, ``(out, in)``, so :func:`params_from_jax`
transposes them and :func:`params_to_jax` transposes them back. The
``mlp_*_w`` parameters are ``(out, in)`` in both. Everything is float32,
as in the flax tree.

BERT (``apex_tpu.models.bert.Bert``): ``word_embeddings``,
``position_embeddings``, ``token_type_embeddings``, ``emb_norm.weight``
(flax ``emb_norm/weight``) and per layer ``layer.{i}.`` (flax
``layer_{i}/``): ``qkv`` / ``attn_out`` ``{weight,bias}`` (kernels
transposed to ``(out, in)`` as for GPT-2), ``attn_norm.weight``,
``mlp_fc_w (I, e)``, ``mlp_fc_b``, ``mlp_proj_w (e, I)``, ``mlp_proj_b``
and ``mlp_norm.weight``.

ResNet (``apex_tpu.models.resnet.ResNet``): the flax ``params`` and
``batch_stats`` trees become one dict in the port's module names, the flax
path with ``.`` for ``/``: convolution kernels ``(kh, kw, in, out)``
become ``weight (out, in, kh, kw)``, the dense ``fc/kernel (in, out)``
becomes ``fc.weight (out, in)``, BatchNorm ``weight`` / ``bias`` stay, and
the ``batch_stats`` ``mean`` / ``var`` become the BatchNorm modules'
buffers of those names.

A model of ``apex_tpu.contrib.group_norm.GroupNorm`` and bias-free flax
convolutions (a UNet ResNet block) maps by the same rule: GroupNorm
``weight`` / ``bias`` stay, convolution kernels become OIHW
``weight`` tensors.

The attention modules (``apex_tpu.transformer.mha``): each ``nn.Dense``
kernel ``(in, out)`` becomes ``<name>.weight (out, in)``
(:func:`mha_params_from_jax`). ``FusedDense``, ``FusedDenseGeluDense``
and ``MLP`` store ``(out, in)`` weights in both packages under the same
names (:func:`dense_params_from_jax`).
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict

import numpy as np
import torch

# flax's lecun_normal: variance_scaling(1.0, "fan_in", "truncated_normal")
# draws from a normal truncated at +-2 sigma, rescaled by this constant so
# the truncated distribution keeps variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _n_layer(p: Dict[str, Any]) -> int:
    return sum(1 for k in p if re.fullmatch(r"h_\d+", k))


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The flax GPT-2 tree (``{"params": {...}}`` or its inner dict), with
    numpy leaves, as the port's CPU float32 parameter dict."""
    p = tree["params"] if "params" in tree else tree
    out = {"wte": _t(p["wte"]), "wpe": _t(p["wpe"]),
           "ln_f.weight": _t(p["ln_f"]["weight"]),
           "ln_f.bias": _t(p["ln_f"]["bias"])}
    for i in range(_n_layer(p)):
        blk, pre = p[f"h_{i}"], f"h.{i}."
        for ln in ("ln_1", "ln_2"):
            out[pre + ln + ".weight"] = _t(blk[ln]["weight"])
            out[pre + ln + ".bias"] = _t(blk[ln]["bias"])
        for dense in ("attn_qkv", "attn_out"):
            out[pre + dense + ".weight"] = _t(blk[dense]["kernel"]).t() \
                .contiguous()
            out[pre + dense + ".bias"] = _t(blk[dense]["bias"])
        for name in ("mlp_fc_w", "mlp_fc_b", "mlp_proj_w", "mlp_proj_b"):
            out[pre + name] = _t(blk[name])
    return out


def params_to_jax(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`params_from_jax`: a dict in the port's names
    (parameters, or gradients / optimizer moments keyed like them) as the
    flax tree ``{"params": {...}}`` with float32 numpy leaves."""
    def a(name):
        return params[name].detach().float().cpu().numpy()

    n_layer = sum(1 for k in params if re.fullmatch(r"h\.\d+\.ln_1\.weight",
                                                    k))
    p: Dict[str, Any] = {
        "wte": a("wte"), "wpe": a("wpe"),
        "ln_f": {"weight": a("ln_f.weight"), "bias": a("ln_f.bias")}}
    for i in range(n_layer):
        pre = f"h.{i}."
        blk: Dict[str, Any] = {}
        for ln in ("ln_1", "ln_2"):
            blk[ln] = {"weight": a(pre + ln + ".weight"),
                       "bias": a(pre + ln + ".bias")}
        for dense in ("attn_qkv", "attn_out"):
            blk[dense] = {"kernel": np.ascontiguousarray(
                a(pre + dense + ".weight").T),
                "bias": a(pre + dense + ".bias")}
        for name in ("mlp_fc_w", "mlp_fc_b", "mlp_proj_w", "mlp_proj_b"):
            blk[name] = a(pre + name)
        p[f"h_{i}"] = blk
    return {"params": p}


def _draws(seed: int):
    """``(normal(shape, std), lecun(out_f, in_f))`` drawing from one CPU
    generator seeded with ``seed``, with flax's distributions."""
    g = torch.Generator().manual_seed(int(seed))

    def normal(shape, std):
        return torch.empty(shape).normal_(0.0, std, generator=g)

    def lecun(out_f, in_f):
        std = math.sqrt(1.0 / in_f) / _TRUNC_STD
        w = torch.empty(out_f, in_f)
        torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                    generator=g)
        return w

    return normal, lecun


def init_gpt2_params(cfg, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random GPT-2 parameters with flax's distributions, from a CPU
    ``torch.Generator`` seeded with ``seed``: ``wte`` normal(0.02),
    ``wpe`` normal(0.01), dense kernels lecun-normal (truncated at two
    sigma, variance 1 / fan_in), ``mlp_*_w`` normal(0.02), LayerNorm
    weights one, every bias zero. The numbers differ from a flax init
    with the same seed (another generator); the distributions do not."""
    normal, lecun = _draws(seed)
    e = cfg.n_embd
    out = {"wte": normal((cfg.vocab_size, e), 0.02),
           "wpe": normal((cfg.n_positions, e), 0.01),
           "ln_f.weight": torch.ones(e), "ln_f.bias": torch.zeros(e)}
    for i in range(cfg.n_layer):
        pre = f"h.{i}."
        out[pre + "ln_1.weight"] = torch.ones(e)
        out[pre + "ln_1.bias"] = torch.zeros(e)
        out[pre + "attn_qkv.weight"] = lecun(3 * e, e)
        out[pre + "attn_qkv.bias"] = torch.zeros(3 * e)
        out[pre + "attn_out.weight"] = lecun(e, e)
        out[pre + "attn_out.bias"] = torch.zeros(e)
        out[pre + "ln_2.weight"] = torch.ones(e)
        out[pre + "ln_2.bias"] = torch.zeros(e)
        out[pre + "mlp_fc_w"] = normal((4 * e, e), 0.02)
        out[pre + "mlp_fc_b"] = torch.zeros(4 * e)
        out[pre + "mlp_proj_w"] = normal((e, 4 * e), 0.02)
        out[pre + "mlp_proj_b"] = torch.zeros(e)
    return out


_BERT_DENSE = ("qkv", "attn_out")
_BERT_MLP = ("mlp_fc_w", "mlp_fc_b", "mlp_proj_w", "mlp_proj_b")
_BERT_NORMS = ("attn_norm", "mlp_norm")
_BERT_EMB = ("word_embeddings", "position_embeddings",
             "token_type_embeddings")


def bert_params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The flax BERT tree (``{"params": {...}}`` or its inner dict), with
    numpy leaves, as the port's CPU float32 parameter dict."""
    p = tree["params"] if "params" in tree else tree
    out = {name: _t(p[name]) for name in _BERT_EMB}
    out["emb_norm.weight"] = _t(p["emb_norm"]["weight"])
    n_layer = sum(1 for k in p if re.fullmatch(r"layer_\d+", k))
    for i in range(n_layer):
        blk, pre = p[f"layer_{i}"], f"layer.{i}."
        for dense in _BERT_DENSE:
            out[pre + dense + ".weight"] = _t(blk[dense]["kernel"]).t() \
                .contiguous()
            out[pre + dense + ".bias"] = _t(blk[dense]["bias"])
        for norm in _BERT_NORMS:
            out[pre + norm + ".weight"] = _t(blk[norm]["weight"])
        for name in _BERT_MLP:
            out[pre + name] = _t(blk[name])
    return out


def bert_params_to_jax(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`bert_params_from_jax`: a dict in the port's
    names (parameters, or gradients keyed like them) as the flax tree
    ``{"params": {...}}`` with float32 numpy leaves."""
    def a(name):
        return params[name].detach().float().cpu().numpy()

    n_layer = sum(1 for k in params
                  if re.fullmatch(r"layer\.\d+\.qkv\.weight", k))
    p: Dict[str, Any] = {name: a(name) for name in _BERT_EMB}
    p["emb_norm"] = {"weight": a("emb_norm.weight")}
    for i in range(n_layer):
        pre = f"layer.{i}."
        blk: Dict[str, Any] = {}
        for dense in _BERT_DENSE:
            blk[dense] = {"kernel": np.ascontiguousarray(
                a(pre + dense + ".weight").T),
                "bias": a(pre + dense + ".bias")}
        for norm in _BERT_NORMS:
            blk[norm] = {"weight": a(pre + norm + ".weight")}
        for name in _BERT_MLP:
            blk[name] = a(pre + name)
        p[f"layer_{i}"] = blk
    return {"params": p}


def init_bert_params(cfg, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random BERT parameters with the flax model's distributions, from a
    CPU ``torch.Generator`` seeded with ``seed``: the three embedding
    tables and ``mlp_*_w`` normal(0.02), dense kernels lecun-normal, norm
    weights one, every bias zero. The numbers differ from a flax init with
    the same seed; the distributions do not."""
    normal, lecun = _draws(seed)
    e, inter = cfg.hidden_size, cfg.intermediate_size
    out = {"word_embeddings": normal((cfg.vocab_size, e), 0.02),
           "position_embeddings": normal((cfg.max_position_embeddings, e),
                                         0.02),
           "token_type_embeddings": normal((cfg.type_vocab_size, e), 0.02),
           "emb_norm.weight": torch.ones(e)}
    for i in range(cfg.num_hidden_layers):
        pre = f"layer.{i}."
        out[pre + "qkv.weight"] = lecun(3 * e, e)
        out[pre + "qkv.bias"] = torch.zeros(3 * e)
        out[pre + "attn_out.weight"] = lecun(e, e)
        out[pre + "attn_out.bias"] = torch.zeros(e)
        out[pre + "attn_norm.weight"] = torch.ones(e)
        out[pre + "mlp_fc_w"] = normal((inter, e), 0.02)
        out[pre + "mlp_fc_b"] = torch.zeros(inter)
        out[pre + "mlp_proj_w"] = normal((e, inter), 0.02)
        out[pre + "mlp_proj_b"] = torch.zeros(e)
        out[pre + "mlp_norm.weight"] = torch.ones(e)
    return out


def _walk(tree: Dict[str, Any], prefix: str = ""):
    """``(dotted path, leaf)`` of a nested dict, keys in sorted order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _walk(v, prefix + k + ".")
        else:
            yield prefix + k, v


def resnet_params_from_jax(variables: Dict[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    """The flax ResNet variables (``{"params": ..., "batch_stats": ...}``,
    numpy leaves) as the port's CPU float32 state dict (parameters and
    running statistics). Without ``batch_stats`` (a gradient tree) only the
    parameters come back. The same rule carries any model of bias-free
    ``flax.linen.Conv`` layers and norms, such as one of
    ``apex_tpu.contrib.group_norm.GroupNorm`` and convolutions, to the
    port's :class:`~apex_tpu_torch.contrib.group_norm.GroupNorm` and
    :class:`~apex_tpu_torch.models.resnet.Conv` modules of the same names:
    ``weight`` / ``bias`` as they are, each conv ``kernel`` (HWIO) as a
    ``weight`` (OIHW)."""
    out = {}
    for group in ("params", "batch_stats"):
        for path, leaf in _walk(variables.get(group, {})):
            a = _t(leaf)
            if path.endswith(".kernel"):
                path = path[:-len("kernel")] + "weight"
                a = a.permute(3, 2, 0, 1) if a.dim() == 4 else a.t()
            out[path] = a.contiguous()
    return out


def resnet_params_to_jax(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`resnet_params_from_jax`: a dict in the port's
    names (a state dict, or gradients keyed like the parameters) as the
    flax variables ``{"params": ..., "batch_stats": ...}`` (the second only
    where running statistics are given) with float32 numpy leaves."""
    out: Dict[str, Any] = {}
    for name, t in params.items():
        a = t.detach().float().cpu()
        *path, leaf = name.split(".")
        group = "batch_stats" if leaf in ("mean", "var") else "params"
        if leaf == "weight" and a.dim() in (2, 4):
            leaf = "kernel"
            a = a.permute(2, 3, 1, 0) if a.dim() == 4 else a.t()
        node = out.setdefault(group, {})
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(a.numpy())
    return out


def mha_params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The flax ``SelfMultiheadAttn`` / ``EncdecMultiheadAttn`` parameters
    (``{"params": {...}}`` or its inner dict, numpy leaves) as the port
    module's CPU float32 state dict: each ``nn.Dense`` (``qkv``, ``out``;
    ``q``, ``kv``, ``out``) ``kernel (in, out)`` becomes ``<name>.weight
    (out, in)``, its ``bias`` ``<name>.bias``."""
    p = tree["params"] if "params" in tree else tree
    out = {}
    for path, leaf in _walk(p):
        a = _t(leaf)
        if path.endswith(".kernel"):
            path, a = path[:-len("kernel")] + "weight", a.t()
        out[path] = a.contiguous()
    return out


def mha_params_to_jax(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`mha_params_from_jax`: a dict in the port's
    names (parameters, or gradients keyed like them) as ``{"params":
    {...}}`` with float32 numpy leaves."""
    p: Dict[str, Any] = {}
    for name, t in params.items():
        dense, leaf = name.rsplit(".", 1)
        a = t.detach().float().cpu()
        if leaf == "weight":
            leaf, a = "kernel", a.t()
        p.setdefault(dense, {})[leaf] = np.ascontiguousarray(a.numpy())
    return {"params": p}


def dense_params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The flax ``FusedDense`` / ``FusedDenseGeluDense`` / ``MLP``
    parameters (``{"params": {...}}`` or its inner dict) as the port
    module's CPU float32 state dict. Their weights are ``(out, in)`` in
    both packages and keep their names (``weight``, ``bias``;
    ``weight1`` ... ``bias2``; ``weight_{i}``, ``bias_{i}``)."""
    p = tree["params"] if "params" in tree else tree
    return {name: _t(leaf) for name, leaf in p.items()}


def dense_params_to_jax(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`dense_params_from_jax`."""
    return {"params": {name: t.detach().float().cpu().numpy()
                       for name, t in params.items()}}


def init_resnet_params(seed: int = 0, stage_sizes=(3, 4, 6, 3),
                       num_classes: int = 1000) -> Dict[str, torch.Tensor]:
    """A random ResNet state dict (``stage_sizes`` (3, 4, 6, 3) is
    ResNet-50) with the flax model's distributions, from a CPU
    ``torch.Generator`` seeded with ``seed``: convolution and dense kernels
    lecun-normal (truncated at two sigma, variance 1 / fan_in, fan_in =
    kh * kw * in for a convolution), the dense bias zero, BatchNorm weights
    one and biases zero, running means zero and variances one. The numbers
    differ from a flax init with the same seed; the distributions do
    not."""
    from apex_tpu_torch.models.resnet import ResNet
    _, lecun = _draws(seed)
    shapes = {n: tuple(t.shape) for n, t in ResNet(
        stage_sizes, num_classes, device="cpu").state_dict().items()}
    out = {}
    for name, shape in shapes.items():
        leaf = name.rsplit(".", 1)[1]
        if leaf == "weight" and len(shape) == 4:
            o, i, kh, kw = shape
            out[name] = lecun(o, i * kh * kw).reshape(shape)
        elif leaf == "weight" and len(shape) == 2:
            out[name] = lecun(*shape)
        elif leaf in ("weight", "var"):
            out[name] = torch.ones(shape)
        else:                          # biases, running means
            out[name] = torch.zeros(shape)
    return out
