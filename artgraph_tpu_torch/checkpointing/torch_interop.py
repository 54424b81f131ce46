"""Reference .pt checkpoints in and out of the port, and the JAX weights
carried over.

The port's modules use the reference state_dict keys (timm ViT names, the
torchvision ResNet50 trunk wrapped in Sequential(*children[:-1]), or with
torchvision's own names in the MultiModal models, plus the wrapper heads of
artgraph_tpu/checkpointing/torch_interop.py `_MODEL_SPECS`),
so a reference .pt loads with `load_state_dict(strict=True)` and no key map,
and `save_reference_checkpoint` writes one (the trainers' best checkpoint).

`state_dict_from_flax` turns the JAX package's variables (a nested dict of
arrays, params and batch_stats) into that state_dict: Linear kernels
[in, out] -> [out, in], convs HWIO -> OIHW, BatchNorm scale/bias/mean/var ->
weight/bias/running_mean/running_var. It is numpy-only and re-states
artgraph_tpu.checkpointing.torch_interop.export_model_state for the
fourteen models of the reference (`vit_to_torch`, `resnet_to_torch`, the
three head kinds: a bare Linear, Sequential(Dropout, Linear) and the
MultiModal models' tanh encoder), which
the port cannot import (that package pulls in jax); the tests hold the two
equal key for key. `gnn_state_from_flax` does the same for the GNN stage's
`HeteroSGNN`, whose port keeps the flax names.

`import_trunk_state` renames a trunk-only or foreign checkpoint's trunk
into a model's keys for --init_checkpoint warm starts, as the JAX
package's `import_trunk_state` does; `jax_top` names a state_dict entry by
the JAX variables' collection and module (`params/resnet`,
`batch_stats/resnet`, `params/classifier`), the names the warm start's
report prints in both packages.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from artgraph_tpu_torch.models import heads
from artgraph_tpu_torch.models.heads import RESNET_DIM, TIMM_HEAD_CLASSES

# model name -> {flax module: (torch prefix, kind)}; kind "linear" is a bare
# Linear (`encoder.weight`), "seq_linear" a Sequential(Dropout, Linear)
# (`classifier.1.weight`), "tanh_encoder" the MultiModal models'
# Sequential(Linear, Tanh, Linear, Tanh) (`encoder.0.*`, `encoder.2.*`)
_HEADS = {
    "ResnetSingleTask": {"classifier": ("classifier", "seq_linear")},
    "ResnetMultiTask": {
        "style_classifier": ("style_classifier", "seq_linear"),
        "genre_classifier": ("genre_classifier", "seq_linear")},
    "ContextNetSingleTask": {"classifier": ("classifier", "linear"),
                             "encoder": ("encoder", "linear")},
    "ContextNetlMultiTask": {"class_style": ("class_style", "linear"),
                             "class_genre": ("class_genre", "linear"),
                             "encoder": ("encoder", "linear")},
    "MultiModalSingleTask": {"classifier": ("classifier", "seq_linear"),
                             "encoder": ("encoder", "tanh_encoder")},
    "MultiModalMultiTask": {"class_style": ("class_style", "seq_linear"),
                            "class_genre": ("class_genre", "seq_linear"),
                            "encoder": ("encoder", "tanh_encoder")},
    "NewMultiModalSingleTask": {"classifier": ("classifier", "seq_linear")},
    "NewMultiModalMultiTask": {
        "class_style": ("class_style", "seq_linear"),
        "class_genre": ("class_genre", "seq_linear")},
    "ViTSingleTask": {"head": ("vit.head", "seq_linear")},
    "ViTMultiTask": {
        "style_classifier": ("style_classifier", "seq_linear"),
        "genre_classifier": ("genre_classifier", "seq_linear")},
    "NewMultiModalSingleTaskVit": {
        "classifier": ("classifier", "seq_linear")},
    "NewMultiModalMultiTaskViT": {
        "class_style": ("class_style", "seq_linear"),
        "class_genre": ("class_genre", "seq_linear")},
    "LabelProjector": {"encoder": ("encoder", "linear")},
    "LabelProjectorVit": {"encoder": ("encoder", "linear")},
}
MODEL_NAMES = tuple(_HEADS)
PROJECTORS = ("LabelProjector", "LabelProjectorVit")
RESNET_MODELS = ("ResnetSingleTask", "ResnetMultiTask",
                 "ContextNetSingleTask", "ContextNetlMultiTask",
                 "MultiModalSingleTask", "MultiModalMultiTask",
                 "NewMultiModalSingleTask", "NewMultiModalMultiTask",
                 "LabelProjector")
# the models whose trunk keeps torchvision's child names (resnet.conv1.*)
NAMED_TRUNK = ("MultiModalSingleTask", "MultiModalMultiTask")
# the suffix of each head kind's last Linear, whose [out, in] shape gives
# build_model the class counts and the embedding width
_LAST_LINEAR = {"linear": "", "seq_linear": ".1", "tanh_encoder": ".2"}

# torchvision resnet50 child name -> its index in Sequential(*children[:-1])
# (children: conv1, bn1, relu, maxpool, layer1..4, avgpool)
_SEQ_INDEX = {"conv1": "0", "bn1": "1", "layer1": "4", "layer2": "5",
              "layer3": "6", "layer4": "7"}


def _f32(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32))


def _linear(k) -> np.ndarray:    # flax [in, out] -> torch [out, in]
    return _f32(k).T.copy()


def _conv(k) -> np.ndarray:      # flax HWIO -> torch OIHW
    return np.ascontiguousarray(_f32(k).transpose(3, 2, 0, 1))


def attention_state_from_flax(params: dict, prefix: str = ""
                              ) -> dict[str, np.ndarray]:
    """A flax `Attention`'s params ({'qkv', 'proj'}, each a Dense kernel
    [in, out] and bias) -> the port's `Attention` state_dict entries
    (`qkv.weight` [out, in], ...) under prefix. A gradient tree of the same
    structure maps the same way."""
    pre = f"{prefix}." if prefix else ""
    out = {}
    for dense in ("qkv", "proj"):
        out[f"{pre}{dense}.weight"] = _linear(params[dense]["kernel"])
        out[f"{pre}{dense}.bias"] = _f32(params[dense]["bias"])
    return out


def vit_state_from_flax(params: dict, prefix: str = "vit"
                        ) -> dict[str, np.ndarray]:
    """A flax `ViT`'s params -> timm-keyed state_dict entries under prefix.

    Depth is read from the params (`block0`, `block1`, ...), so trunks of any
    size convert; an empty prefix gives bare timm keys. The tree, and so the
    state_dict, is the same for `fuse_qkv` True and False. A gradient tree of
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
        out.update(attention_state_from_flax(blk["attn"], f"{b}.attn"))
        for dense in ("fc1", "fc2"):
            out[f"{b}.mlp.{dense}.weight"] = _linear(
                blk["mlp"][dense]["kernel"])
            out[f"{b}.mlp.{dense}.bias"] = _f32(blk["mlp"][dense]["bias"])
    return out


def resnet_state_from_flax(params: dict, batch_stats: dict,
                           prefix: str = "resnet", seq: bool = True
                           ) -> dict[str, np.ndarray]:
    """A flax `ResNet50`'s params and batch_stats -> torchvision-keyed
    state_dict entries under prefix, index-prefixed (`resnet.0.weight`,
    `resnet.4.0.conv1.weight`) with seq, named (`resnet.conv1.weight`)
    without; an empty prefix gives the bare trunk's keys. Depth is read from
    the params (`layer<stage>_<block>`), so trunks of any stage sizes
    convert.
    """
    pre = f"{prefix}." if prefix else ""

    def key(child: str, rest: str) -> str:
        return f"{pre}{_SEQ_INDEX[child] if seq else child}.{rest}"

    out: dict[str, np.ndarray] = {}

    def bn(p: dict, s: dict, child: str, rest: str) -> None:
        out[key(child, f"{rest}weight")] = _f32(p["scale"])
        out[key(child, f"{rest}bias")] = _f32(p["bias"])
        out[key(child, f"{rest}running_mean")] = _f32(s["mean"])
        out[key(child, f"{rest}running_var")] = _f32(s["var"])
        out[key(child, f"{rest}num_batches_tracked")] = np.zeros((), np.int64)

    def stats(*path: str) -> dict:
        return functools.reduce(dict.__getitem__, path, batch_stats)

    out[key("conv1", "weight")] = _conv(params["conv1"]["kernel"])
    bn(params["bn1"], stats("bn1"), "bn1", "")
    blocks = sorted((int(n[5]), int(n.split("_")[1]), n)
                    for n in params if n.startswith("layer"))
    for stage, block, name in blocks:
        p, layer = params[name], f"layer{stage}"
        for i in (1, 2, 3):
            out[key(layer, f"{block}.conv{i}.weight")] = _conv(
                p[f"conv{i}"]["kernel"])
            bn(p[f"bn{i}"], stats(name, f"bn{i}"), layer, f"{block}.bn{i}.")
        if "downsample_conv" in p:
            out[key(layer, f"{block}.downsample.0.weight")] = _conv(
                p["downsample_conv"]["kernel"])
            bn(p["downsample_bn"], stats(name, "downsample_bn"), layer,
               f"{block}.downsample.1.")
    return out


def state_dict_from_flax(model_name: str, variables: dict
                         ) -> dict[str, np.ndarray]:
    """JAX variables {'params': ..., 'batch_stats': ...} of one of
    MODEL_NAMES -> reference state_dict (numpy), the same key set and values
    as the JAX package's export_model_state."""
    if model_name not in _HEADS:
        raise ValueError(f"unsupported model {model_name!r}; the port has "
                         f"{MODEL_NAMES}")
    params = variables["params"]
    if model_name in RESNET_MODELS:
        sd = resnet_state_from_flax(
            params["resnet"], variables["batch_stats"]["resnet"],
            seq=model_name not in NAMED_TRUNK)
    else:
        sd = vit_state_from_flax(params["vit"], "vit")
    if model_name not in RESNET_MODELS + ("ViTSingleTask",):
        # timm's 1000-class head survives in the reference state_dicts of the
        # models that never call it
        width = np.shape(params["vit"]["cls_token"])[-1]
        sd["vit.head.weight"] = np.zeros((TIMM_HEAD_CLASSES, width),
                                         np.float32)
        sd["vit.head.bias"] = np.zeros((TIMM_HEAD_CLASSES,), np.float32)
    for flax_name, (tprefix, kind) in _HEADS[model_name].items():
        sd.update(_head_state(params[flax_name], tprefix, kind))
    return sd


def _head_state(p: dict, tprefix: str, kind: str) -> dict[str, np.ndarray]:
    """One head's flax params -> its state_dict entries under tprefix."""
    if kind == "linear":
        denses = {"": p}
    elif kind == "seq_linear":
        denses = {".1": p["linear"]}
    else:                                   # tanh_encoder
        denses = {".0": p["fc1"], ".2": p["fc2"]}
    out = {}
    for sub, dense in denses.items():
        out[f"{tprefix}{sub}.weight"] = _linear(dense["kernel"])
        out[f"{tprefix}{sub}.bias"] = _f32(dense["bias"])
    return out


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


def _trunk_child(rest: str, seq: bool) -> str | None:
    """The child of a torchvision ResNet50 key (`conv1.weight`,
    `4.0.conv1.weight`) in the index (seq) or named layout, renamed to the
    other layout as asked; None for what is not a trunk child (fc)."""
    child, _, tail = rest.partition(".")
    named = {v: k for k, v in _SEQ_INDEX.items()}.get(child, child)
    if named not in _SEQ_INDEX:
        return None
    return f"{_SEQ_INDEX[named] if seq else named}.{tail}"


def import_trunk_state(model_name: str, sd: dict) -> dict:
    """Trunk-only import for warm starts (--init_checkpoint): the trunk
    entries of the state_dict sd under model_name's keys.

    Accepts raw torchvision resnet50 (`conv1.weight`, ...) and raw timm ViT
    (`cls_token`, `patch_embed.proj.weight`, ...) state_dicts, the
    pretrained files the reference fine-tunes from (ref: models.py:51,97),
    and reference checkpoints of any model that shares the trunk, with the
    index-prefixed (`resnet.0.weight`) or named (`resnet.conv1.weight`)
    ResNet layout. Heads are never imported, nor timm's classifier head,
    nor BatchNorm's num_batches_tracked (the JAX variables have none).
    Raises KeyError when sd holds no tensor of the trunk.
    """
    if model_name not in _HEADS:
        raise ValueError(f"unsupported model {model_name!r}; the port has "
                         f"{MODEL_NAMES}")
    out = {}
    if model_name in RESNET_MODELS:
        seq = model_name not in NAMED_TRUNK
        prefix = "" if "conv1.weight" in sd else "resnet."
        for k, v in sd.items():
            if not k.startswith(prefix) or k.endswith("num_batches_tracked"):
                continue
            rest = _trunk_child(k[len(prefix):], seq)
            if rest is not None:
                out[f"resnet.{rest}"] = v
    else:
        prefix = "" if "cls_token" in sd else "vit."
        for k, v in sd.items():
            if k.startswith(prefix) and not k[len(prefix):].startswith(
                    "head."):
                out[f"vit.{k[len(prefix):]}"] = v
    if not out:
        trunk = "ResNet50" if model_name in RESNET_MODELS else "ViT"
        raise KeyError(f"no {trunk} trunk tensor for {model_name} among "
                       f"{len(sd)} tensors (e.g. {sorted(sd)[:3]})")
    return out


def jax_top(model_name: str, key: str) -> str:
    """`<collection>/<module>` of the JAX variables that hold the port's
    state_dict entry `key` of model_name: `batch_stats` for BatchNorm
    running statistics, `params` otherwise; the module is the head's flax
    name or the trunk's (`resnet`, `vit`)."""
    collection = ("batch_stats" if key.endswith(("running_mean",
                                                 "running_var"))
                  else "params")
    for flax_name, (tprefix, _) in _HEADS[model_name].items():
        if key.startswith(f"{tprefix}."):
            return f"{collection}/{flax_name}"
    return f"{collection}/{key.split('.')[0]}"


def jax_counterpart_keys(model_name: str, keys) -> list:
    """The entries of a model_name state_dict that the JAX variables hold:
    all but num_batches_tracked and, in the models that keep it unused,
    timm's 1000-class `vit.head` (the JAX export writes both as
    constants)."""
    timm_head = model_name not in RESNET_MODELS + ("ViTSingleTask",)
    return [k for k in keys if not k.endswith("num_batches_tracked")
            and not (timm_head and k.startswith("vit.head."))]


def build_model(model_name: str, sd: dict, dtype: torch.dtype = torch.bfloat16
                ) -> nn.Module:
    """The port's module for model_name, with class counts and embedding width
    read from the head (or encoder) shapes in sd (parameters uninitialised,
    on `meta`)."""
    if model_name not in _HEADS:
        raise ValueError(f"unsupported model {model_name!r}; the port has "
                         f"{MODEL_NAMES}")
    shape = {tprefix: tuple(sd[f"{tprefix}{_LAST_LINEAR[kind]}.weight"]
                            .shape)
             for tprefix, kind in _HEADS[model_name].values()}
    nc = lambda style, genre: {"style": shape[style][0],
                               "genre": shape[genre][0]}
    with torch.device("meta"):
        if model_name in PROJECTORS:
            return getattr(heads, model_name)(shape["encoder"][0],
                                              dtype=dtype)
        if model_name == "ResnetSingleTask":
            return heads.ResnetSingleTask(shape["classifier"][0], dtype=dtype)
        if model_name == "ResnetMultiTask":
            return heads.ResnetMultiTask(
                nc("style_classifier", "genre_classifier"), dtype=dtype)
        if model_name in ("ContextNetSingleTask", "MultiModalSingleTask"):
            return getattr(heads, model_name)(
                shape["encoder"][0], shape["classifier"][0], dtype=dtype)
        if model_name in ("ContextNetlMultiTask", "MultiModalMultiTask"):
            return getattr(heads, model_name)(
                shape["encoder"][0], nc("class_style", "class_genre"),
                dtype=dtype)
        if model_name == "NewMultiModalSingleTask":
            n, width = shape["classifier"]
            return heads.NewMultiModalSingleTask(width - RESNET_DIM, n,
                                                 dtype=dtype)
        if model_name == "NewMultiModalMultiTask":
            return heads.NewMultiModalMultiTask(
                shape["class_style"][1] - RESNET_DIM,
                nc("class_style", "class_genre"), dtype=dtype)
        if model_name == "ViTSingleTask":
            return heads.ViTSingleTask(shape["vit.head"][0], dtype=dtype)
        if model_name == "ViTMultiTask":
            return heads.ViTMultiTask(
                nc("style_classifier", "genre_classifier"), dtype=dtype)
        vit_dim = sd["vit.cls_token"].shape[-1]
        if model_name == "NewMultiModalSingleTaskVit":
            n, width = shape["classifier"]
            return heads.NewMultiModalSingleTaskVit(width - vit_dim, n,
                                                    dtype=dtype)
        return heads.NewMultiModalMultiTaskViT(
            shape["class_style"][1] - vit_dim,
            nc("class_style", "class_genre"), dtype=dtype)


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
