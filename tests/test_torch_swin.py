"""The port's Swin trunk (artgraph_tpu_torch/models/swin.py) on the CPU, where
its blocks run the plain twins of `fused_block_attention` (with the bias and
the shift mask) and `fused_block_mlp`, held against the timm oracle of
tests/_torch_oracles.py (plain torch: roll, window partition and reverse,
the relative-position index and mask as timm builds them; nothing of the
port) at a small configuration that keeps Swin-B's head dim 32, a shifted
stage of four windows and a last stage of one window (no shift).

Tolerances, relative L2 of the feature and of every parameter's gradient:
  f64  F64_TOL = 1e-10: the two compute the same equations and differ only
       in where the 1/sqrt(D) scale is applied (timm scales q before the
       product, the port the product) and in summation order, ~1e-15;
  f32  F32_TOL = 2e-5: the same differences at f32's 6e-8 unit round-off,
       grown through the 4 blocks and 2 LayerNorm'd stages (~1e-6 seen);
  bf16 the port's policy (bf16 stream and operands, f32 statistics) misses
       F32_TOL: it rounds at 4e-3, so its distance is ~1e-2.
Then timm's constructions one by one (the relative-position index, the shift
mask, the patch-merging order, the window layout the stream is gathered
into), a timm-keyed state_dict loading with no key map, the bias table's
gradient gathered in a fixed order, and one CPU epoch of
`train_new_multimodal_multitask --architecture swin`.
"""
import functools
import os
import shutil

import numpy as np
import pytest
import torch

from _torch_oracles import (SwinOracle, SwinPatchMergingOracle,
                            timm_attn_mask, timm_relative_position_index,
                            timm_window_partition)
from artgraph_tpu_torch import config
from artgraph_tpu_torch.models import SwinTransformer, heads, init_random_
from artgraph_tpu_torch.models import swin

torch.set_num_threads(2)

TINY = dict(img_size=32, patch_size=4, embed_dim=64, depths=(2, 2),
            num_heads=(2, 4))
WINDOW = 4
F64_TOL, F32_TOL = 1e-10, 2e-5


def _rel(a: torch.Tensor, r: torch.Tensor) -> float:
    a, r = a.double(), r.double()
    return ((a - r).norm() / r.norm()).item()


def _trunk_state(oracle: SwinOracle) -> dict:
    """The oracle's state_dict without timm's classifier head."""
    return {k: v for k, v in oracle.state_dict().items()
            if not k.startswith("head.")}


def _models(dtype: torch.dtype, port_dtype: torch.dtype, seed: int = 3):
    oracle = SwinOracle(window=WINDOW, **TINY).to(dtype)
    init_random_(oracle, torch.Generator().manual_seed(seed))
    # non-zero bias tables, as timm draws them, so the bias paths count
    with torch.no_grad():
        g = torch.Generator().manual_seed(seed + 1)
        for name, p in oracle.named_parameters():
            if name.endswith("relative_position_bias_table"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.5)
    port = SwinTransformer(window_size=WINDOW, dtype=port_dtype, **TINY)
    port = port.to(dtype if port_dtype == dtype else torch.float32)
    port.load_state_dict(_trunk_state(oracle), strict=True)
    return oracle, port


def _feature_and_grads(oracle, port, dtype):
    """(feature, {name: grad}) of each model on the same images, under one
    seeded cotangent."""
    g = torch.Generator().manual_seed(11)
    x = torch.randn(3, 3, TINY["img_size"], TINY["img_size"], generator=g,
                    dtype=torch.float64)
    out = []
    for model, inp in ((oracle, x.to(dtype)),
                       (port, x.permute(0, 2, 3, 1).to(dtype))):
        model.zero_grad()
        feat = (model.forward_features(inp) if model is oracle
                else model(inp))
        cot = torch.randn(feat.shape, generator=torch.Generator()
                          .manual_seed(12), dtype=torch.float64)
        (feat.double() * cot).sum().backward()
        out.append((feat.detach(), {n: p.grad for n, p in
                                    model.named_parameters()
                                    if not n.startswith("head.")}))
    return out


@pytest.mark.parametrize("dtype,tol", [(torch.float64, F64_TOL),
                                       (torch.float32, F32_TOL)])
def test_swin_matches_the_timm_oracle(dtype, tol):
    oracle, port = _models(dtype, dtype)
    (fo, go), (fp, gp) = _feature_and_grads(oracle, port, dtype)
    assert fp.dtype == dtype and fp.shape == (3, 128)
    assert _rel(fp, fo) <= tol
    assert set(gp) == set(go)
    worst = max((_rel(gp[n], go[n]), n) for n in go)
    assert worst[0] <= tol, worst


def test_swin_bf16_path_misses_the_f32_tolerance():
    """The port's bf16 policy against the f32 oracle: a feature off by
    rounding at bf16 (over F32_TOL, within 0.1), the stream in bf16."""
    oracle, port = _models(torch.float32, torch.bfloat16)
    (fo, go), (fp, gp) = _feature_and_grads(oracle, port, torch.float32)
    assert fp.dtype == torch.float32
    assert F32_TOL < _rel(fp, fo) < 0.1
    assert all(g.dtype == torch.float32 for g in gp.values())
    assert max(_rel(gp[n], go[n]) for n in go) > F32_TOL


@pytest.mark.parametrize("window", [4, 7, 12])
def test_relative_position_index_is_timms(window):
    ours = swin.relative_position_index(window)
    assert torch.equal(ours, timm_relative_position_index(window, window))
    assert int(ours.max()) == (2 * window - 1) ** 2 - 1


@pytest.mark.parametrize("res,window,shift", [(8, 4, 2), (96, 12, 6),
                                              (24, 12, 6)])
def test_shift_mask_is_timms(res, window, shift):
    ours = swin.shift_mask(res, window, shift)
    assert ours.dtype == torch.float32
    assert torch.equal(ours, timm_attn_mask(res, window, shift))


def test_patch_merging_order_is_timms():
    """merge_order then the LayerNorm and the Linear on raster rows equals
    the original Swin's x0, x1, x2, x3 slicing on the map."""
    g = torch.Generator().manual_seed(5)
    ref = SwinPatchMergingOracle(6).double()
    init_random_(ref, g)
    x = torch.randn(2, 8, 8, 6, generator=g, dtype=torch.float64)
    merged = swin.merge_order(x.reshape(2, 64, 6), 8)
    ours = ref.reduction(ref.norm(merged)).view(2, 4, 4, 12)
    assert torch.equal(ours, ref(x))


@pytest.mark.parametrize("shift", [0, 2])
def test_window_layout_is_timms_roll_and_partition(shift):
    """window_order lists the raster token of each row of timm's
    partition(roll(x, -shift))."""
    res, window = 8, 4
    idx = torch.arange(res * res).view(1, res, res, 1)
    rolled = torch.roll(idx, shifts=(-shift, -shift), dims=(1, 2))
    ref = timm_window_partition(rolled, window).flatten()
    assert torch.equal(swin.window_order(res, window, shift), ref)


def test_a_timm_state_dict_loads_with_no_key_map(monkeypatch):
    """timm's keys, classifier head included, load strictly into the fusion
    model's trunk; the buffers are not persistent, as in timm."""
    monkeypatch.setattr(heads, "SwinTransformer", functools.partial(
        SwinTransformer, window_size=WINDOW, **TINY))
    oracle = SwinOracle(window=WINDOW, **TINY)
    init_random_(oracle, torch.Generator().manual_seed(7))
    model = heads.NewMultiModalMultiTaskSwin(128, config.NUM_CLASSES,
                                             dtype=torch.float32)
    model.swin.load_state_dict(oracle.state_dict(), strict=True)
    names = set(model.swin.state_dict())
    assert "layers.1.downsample.reduction.weight" in names
    assert "layers.0.blocks.1.attn.relative_position_bias_table" in names
    assert not any("relative_position_index" in n or "attn_mask" in n
                   for n in names)
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        torch.testing.assert_close(model.swin(x), oracle.forward_features(
            x.permute(0, 3, 1, 2)), rtol=2e-5, atol=2e-6)


def test_bias_table_gradient_is_the_index_add_of_dbias():
    """The bias gather's backward (a fixed-order gather and sum) equals
    autograd's scatter-add of table[index] in f64, exactly."""
    window, H = 4, 3
    attn = swin.WindowAttention(8, H, window).double()
    g = torch.Generator().manual_seed(9)
    with torch.no_grad():
        attn.relative_position_bias_table.copy_(
            torch.randn(attn.relative_position_bias_table.shape,
                        generator=g))
    cot = torch.randn(H, 16, 16, generator=g, dtype=torch.float64)
    (attn.bias() * cot).sum().backward()
    ours = attn.relative_position_bias_table.grad
    table = attn.relative_position_bias_table.detach().requires_grad_()
    idx = timm_relative_position_index(window, window).view(-1)
    ref_bias = table[idx].view(16, 16, H).permute(2, 0, 1)
    assert torch.equal(attn.bias().detach(), ref_bias.detach())
    (ref_bias * cot).sum().backward()
    torch.testing.assert_close(ours, table.grad, rtol=1e-14, atol=1e-14)


@pytest.fixture()
def swin_tree(synthetic_dataset, tmp_path, monkeypatch):
    """A private copy of the synthetic tree with one embedding file a split
    (a row per image), the tiny trunk, 32 px images and tmp checkpoints."""
    root = tmp_path / "artgraph"
    shutil.copytree(synthetic_dataset["root"], root)
    from artgraph_tpu_torch.data.embeddings import save_embedding
    rng = np.random.default_rng(0)
    for split, n in synthetic_dataset["counts"].items():
        folder = root / "dataset" / split / "embeddings"
        folder.mkdir(parents=True, exist_ok=True)
        save_embedding(str(folder / "e.pt"),
                       rng.normal(size=(n, config.EMB_SIZE))
                       .astype(np.float32))
    monkeypatch.setattr(heads, "SwinTransformer", functools.partial(
        SwinTransformer, window_size=WINDOW, **TINY))
    monkeypatch.setattr(config, "IMAGE_SIZES", {"swin": TINY["img_size"]})
    monkeypatch.setattr(config, "CHECKPOINTS_DIR", str(tmp_path / "ckpt"))
    os.makedirs(tmp_path / "ckpt")
    return root


def test_train_new_multimodal_multitask_swin_cpu_epoch(swin_tree, tmp_path,
                                                       capsys):
    from artgraph_tpu_torch.cli import train_new_multimodal_multitask

    files = [a for s in ("train", "valid", "test") for t in ("style", "genre")
             for a in (f"--emb_{s}_{t}", "e.pt")]
    style_acc, genre_acc = train_new_multimodal_multitask.main([
        "--dataset_path", str(swin_tree / "dataset"), "--image_path",
        str(swin_tree / "images"), "--device", "cpu", "--num_workers", "2",
        "--architecture", "swin", "--emb_type", "artwork", "--epochs", "1",
        "--batch", "8", "--results_dir", str(tmp_path / "results"), *files])
    out = capsys.readouterr().out
    assert out.count("Train loss: ") == out.count("Validation loss: ") == 1
    loss = float(out.split("Train loss: ")[1].split(";")[0])
    assert np.isfinite(loss)
    assert 0.0 <= style_acc <= 1.0 and 0.0 <= genre_acc <= 1.0
    # the checkpoint is the Swin fusion model's state_dict, timm's keys
    sd = torch.load(os.path.join(config.CHECKPOINTS_DIR,
                                 "new-multimodal_multi-task_checkpoint.pt"),
                    map_location="cpu", weights_only=True)
    model = heads.NewMultiModalMultiTaskSwin(config.EMB_SIZE,
                                             config.NUM_CLASSES)
    model.load_state_dict(sd, strict=True)
    assert "swin.layers.1.blocks.0.attn.relative_position_bias_table" in sd
