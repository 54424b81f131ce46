"""Reference .pt checkpoints in and out of the port, and the JAX weights
carried over.

The port's modules use the reference state_dict keys (timm ViT names plus the
wrapper heads of artgraph_tpu/checkpointing/torch_interop.py `_MODEL_SPECS`),
so a reference .pt loads with `load_state_dict(strict=True)` and no key map,
and `save_reference_checkpoint` writes one (the trainers' best checkpoint).

`state_dict_from_flax` turns the JAX package's variables (a nested dict of
arrays) into that state_dict: Linear kernels [in, out] -> [out, in], convs
HWIO -> OIHW. It is numpy-only and re-states the ViT half of
artgraph_tpu.checkpointing.torch_interop.export_model_state, which the port
cannot import (that package pulls in jax); tests/test_torch_predict.py holds
the two equal key for key. `gnn_state_from_flax` does the same for the GNN
stage's `HeteroSGNN`, whose port keeps the flax names.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from artgraph_tpu_torch.models import heads
from artgraph_tpu_torch.models.heads import TIMM_HEAD_CLASSES, VIT_DIM

# model name -> {flax head: torch prefix of its Sequential(Dropout, Linear)}
_HEADS = {
    "ViTSingleTask": {"head": "vit.head"},
    "ViTMultiTask": {"style_classifier": "style_classifier",
                     "genre_classifier": "genre_classifier"},
    "NewMultiModalSingleTaskVit": {"classifier": "classifier"},
    "NewMultiModalMultiTaskViT": {"class_style": "class_style",
                                  "class_genre": "class_genre"},
}
MODEL_NAMES = tuple(_HEADS)


def _f32(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32))


def _linear(k) -> np.ndarray:    # flax [in, out] -> torch [out, in]
    return _f32(k).T.copy()


def _conv(k) -> np.ndarray:      # flax HWIO -> torch OIHW
    return np.ascontiguousarray(_f32(k).transpose(3, 2, 0, 1))


def vit_state_from_flax(params: dict, prefix: str = "vit"
                        ) -> dict[str, np.ndarray]:
    """A flax `ViT`'s params -> timm-keyed state_dict entries under prefix.

    Depth is read from the params (`block0`, `block1`, ...), so trunks of any
    size convert; an empty prefix gives bare timm keys. A gradient tree of
    the same structure (jax.grad of the params) maps the same way, to the
    layouts of the port's `.grad` tensors.
    """
    pre = f"{prefix}." if prefix else ""
    out = {
        f"{pre}patch_embed.proj.weight":
            _conv(params["patch_embed"]["kernel"]),
        f"{pre}patch_embed.proj.bias": _f32(params["patch_embed"]["bias"]),
        f"{pre}cls_token": _f32(params["cls_token"]),
        f"{pre}pos_embed": _f32(params["pos_embed"]),
        f"{pre}norm.weight": _f32(params["norm"]["scale"]),
        f"{pre}norm.bias": _f32(params["norm"]["bias"]),
    }
    depth = sum(1 for k in params if k.startswith("block"))
    for i in range(depth):
        blk, b = params[f"block{i}"], f"{pre}blocks.{i}"
        for norm in ("norm1", "norm2"):
            out[f"{b}.{norm}.weight"] = _f32(blk[norm]["scale"])
            out[f"{b}.{norm}.bias"] = _f32(blk[norm]["bias"])
        for mod, dense in (("attn", "qkv"), ("attn", "proj"),
                           ("mlp", "fc1"), ("mlp", "fc2")):
            out[f"{b}.{mod}.{dense}.weight"] = _linear(
                blk[mod][dense]["kernel"])
            out[f"{b}.{mod}.{dense}.bias"] = _f32(blk[mod][dense]["bias"])
    return out


def state_dict_from_flax(model_name: str, variables: dict
                         ) -> dict[str, np.ndarray]:
    """JAX variables {'params': ...} of one of MODEL_NAMES -> reference
    state_dict (numpy), the same key set and values as the JAX package's
    export_model_state."""
    if model_name not in _HEADS:
        raise ValueError(f"unsupported model {model_name!r}; the port has "
                         f"{MODEL_NAMES}")
    params = variables["params"]
    sd = vit_state_from_flax(params["vit"], "vit")
    if model_name != "ViTSingleTask":
        # timm's 1000-class head survives in the reference state_dicts of the
        # models that never call it
        sd["vit.head.weight"] = np.zeros((TIMM_HEAD_CLASSES, VIT_DIM),
                                         np.float32)
        sd["vit.head.bias"] = np.zeros((TIMM_HEAD_CLASSES,), np.float32)
    for flax_name, tprefix in _HEADS[model_name].items():
        lin = params[flax_name]["linear"]
        sd[f"{tprefix}.1.weight"] = _linear(lin["kernel"])
        sd[f"{tprefix}.1.bias"] = _f32(lin["bias"])
    return sd


def _flat(tree: dict, prefix: str) -> dict[str, np.ndarray]:
    """A nested dict of arrays -> {'prefix.a.b': f32 array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}.{k}"))
        else:
            out[f"{prefix}.{k}"] = _f32(v)
    return out


def gnn_state_from_flax(variables: dict) -> dict[str, np.ndarray]:
    """A flax `HeteroSGNN`'s {'params', 'batch_stats'} -> the state_dict of
    the port's models.gnn.HeteroSGNN (numpy). The port keeps the flax names
    and layouts, so the map is mechanical:

      <conv>__<src>__<rel>__<dst>/<leaf path> -> convs.<same name>.<leaf path>
      bn<i>__<type>/{scale, bias}             -> bns.<same name>.{weight, bias}
      batch_stats bn<i>__<type>/{mean, var}   -> bns.<same name>.running_*
      prelu<i>                                -> prelu.prelu<i>

    A gradient tree of the params ({'params': grads}) maps the same way.
    """
    sd: dict[str, np.ndarray] = {}
    for name, tree in variables["params"].items():
        if name.startswith("conv"):
            sd.update(_flat(tree, f"convs.{name}"))
        elif name.startswith("bn"):
            sd[f"bns.{name}.weight"] = _f32(tree["scale"])
            sd[f"bns.{name}.bias"] = _f32(tree["bias"])
        elif name.startswith("prelu"):
            sd[f"prelu.{name}"] = _f32(tree)
        else:
            raise ValueError(f"unexpected HeteroSGNN parameter {name!r}")
    for name, stats in variables.get("batch_stats", {}).items():
        sd[f"bns.{name}.running_mean"] = _f32(stats["mean"])
        sd[f"bns.{name}.running_var"] = _f32(stats["var"])
        sd[f"bns.{name}.num_batches_tracked"] = np.zeros((), np.int64)
    return sd


def build_model(model_name: str, sd: dict, dtype: torch.dtype = torch.bfloat16
                ) -> nn.Module:
    """The port's module for model_name, with class counts and embedding width
    read from the head shapes in sd (parameters uninitialised, on `meta`)."""
    if model_name not in _HEADS:
        raise ValueError(f"unsupported model {model_name!r}; the port has "
                         f"{MODEL_NAMES}")
    shape = {tprefix: tuple(sd[f"{tprefix}.1.weight"].shape)
             for tprefix in _HEADS[model_name].values()}
    with torch.device("meta"):
        if model_name == "ViTSingleTask":
            return heads.ViTSingleTask(shape["vit.head"][0], dtype=dtype)
        if model_name == "ViTMultiTask":
            return heads.ViTMultiTask(
                {"style": shape["style_classifier"][0],
                 "genre": shape["genre_classifier"][0]}, dtype=dtype)
        if model_name == "NewMultiModalSingleTaskVit":
            nc, width = shape["classifier"]
            return heads.NewMultiModalSingleTaskVit(width - VIT_DIM, nc,
                                                    dtype=dtype)
        width = shape["class_style"][1]
        return heads.NewMultiModalMultiTaskViT(
            width - VIT_DIM, {"style": shape["class_style"][0],
                              "genre": shape["class_genre"][0]}, dtype=dtype)


def save_reference_checkpoint(model: nn.Module, path: str) -> None:
    """torch.save the model's state_dict (reference keys, f32 CPU tensors):
    the .pt that load_reference_checkpoint and the reference read."""
    torch.save({k: v.detach().to("cpu", torch.float32)
                for k, v in model.state_dict().items()}, path)


def load_reference_checkpoint(model_name: str, path: str,
                              device: str | torch.device,
                              dtype: torch.dtype = torch.bfloat16
                              ) -> nn.Module:
    """torch.load a reference .pt state_dict into the port's module
    (strict=True), in eval mode on `device`; `dtype` is the compute dtype."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    try:
        model = build_model(model_name, sd, dtype)
    except KeyError as e:
        raise KeyError(
            f"checkpoint {path!r} does not match model {model_name!r}: "
            f"missing tensor {e.args[0]!r} (checkpoint has {len(sd)} "
            f"tensors, e.g. {sorted(sd)[:3]})") from e
    model.load_state_dict(sd, strict=True, assign=True)
    return model.to(device).eval()
