"""The model layer (portbench/trunks/): a trunk that exists only in this
test plugs into the harness by its module alone and rehearses a training
and a serving cell; a configuration on a trunk with no module is refused
by name; the seeded draws of the enrolled trunks are those of the rules
the harness had before the lookup."""
import copy
import math
import sys
import time
import types

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from portbench import flops, harness, inputs, reference, trunks
from tiny import BENCH, ROOT, TINY_WORKLOAD, drive, tiny_config

TOY = "portbench.trunks.toy"
TOY_CFG = {**harness.load_json(BENCH / "configs" / "vit_b16_fusion_mt.json"),
           "name": "toy_fusion_mt", "trunk": "toy", "img_size": 32,
           "patch_size": 8, "embed_dim": 48}
KINDS = ("train_resident", "serve")


def _patches(x, p):
    """NHWC [B, H, W, C] -> [B, (H/p)(W/p), p*p*C]."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // p) * (W // p), p * p * C)


class _Toy(nn.Module):
    """A patchify, one Linear, a 2-D bias table over the patches, then the
    mean over the patches."""

    def __init__(self, cfg):
        super().__init__()
        self.p, d = cfg["patch_size"], cfg["embed_dim"]
        self.proj = nn.Linear(3 * self.p ** 2, d)
        self.bias_table = nn.Parameter(
            torch.zeros((cfg["img_size"] // self.p) ** 2, d))


class PlainToy(_Toy):
    """The plain f32 twin."""

    def forward(self, x, p: reference.Precision):
        y = reference.linear(p, _patches(x, self.p), self.proj)
        return (y + self.bias_table).mean(1)


class ToyFusion(nn.Module):
    """The port's side: the trunk's product in the compute dtype, the
    heads in f32 on cat([feature, embedding]), as the port's fusion models
    run them."""

    def __init__(self, emb_size, num_classes, dropout, dtype):
        super().__init__()
        self.toy = _Toy(TOY_CFG)
        self.dtype = dtype
        dim = TOY_CFG["embed_dim"] + emb_size
        self.class_style = nn.Sequential(
            nn.Dropout(dropout), nn.Linear(dim, num_classes["style"]))
        self.class_genre = nn.Sequential(
            nn.Dropout(dropout), nn.Linear(dim, num_classes["genre"]))

    def forward(self, img, emb_style, emb_genre):
        t = self.toy
        y = F.linear(_patches(img, t.p).to(self.dtype),
                     t.proj.weight.to(self.dtype), t.proj.bias.to(self.dtype))
        feat = (y.float() + t.bias_table).mean(1)
        return [self.class_style(torch.cat([feat, emb_style.float()], 1)),
                self.class_genre(torch.cat([feat, emb_genre.float()], 1))]


def _toy_module():
    m = types.ModuleType(TOY)
    m.PREFIX = "toy"
    m.fusion_class = lambda: ToyFusion
    m.Plain = PlainToy
    m.feature_dim = lambda cfg: cfg["embed_dim"]
    m.forward_flops = lambda cfg: (2 * (cfg["img_size"] // cfg["patch_size"])
                                   ** 2 * 3 * cfg["patch_size"] ** 2
                                   * cfg["embed_dim"])
    m.init_scale = lambda name, shape, cfg: (
        (0.0, 0.02) if name.endswith("bias_table") else None)
    m.TINY = {}
    m.patch_tiny = lambda monkeypatch: None
    return m


@pytest.fixture
def toy(monkeypatch):
    monkeypatch.setitem(sys.modules, TOY, _toy_module())


def toy_manifest():
    """BENCHMARK.json with the toy configuration and a toy cell beside each
    ViT cell, listed by every metric that lists the ViT cell."""
    m = copy.deepcopy(harness.load_json(ROOT / "BENCHMARK.json"))
    m["configs"].append({"name": "toy_fusion_mt", "source": "this test",
                         "file": "benchmarks/configs/toy_fusion_mt.json",
                         "reduced": [], "why": "a test-only trunk"})
    for kind in KINDS:
        vit, cell = f"vit_fusion.{kind}", f"toy_fusion.{kind}"
        m["workloads"].append({**next(w for w in m["workloads"]
                                      if w["name"] == vit),
                               "name": cell, "config": "toy_fusion_mt"})
        for metric in m["end_to_end"] + m["per_layer"]:
            if vit in metric.get("workloads", []):
                metric["workloads"].append(cell)
    return m


def toy_run(kind, traced=False, seed=7):
    """A toy cell's run: the ViT cell's workload at the tiny sizes, held to
    the ViT cell's limits."""
    workload = {**harness.load_json(BENCH / "workloads"
                                    / f"vit_fusion.{kind}.json"),
                **TINY_WORKLOAD, "config": "toy_fusion_mt"}
    return harness.Run(f"toy_fusion.{kind}", workload, dict(TOY_CFG), seed,
                       0.0, traced, torch.device("cpu"), time.perf_counter(),
                       toy_manifest())


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_a_test_only_trunk_rehearses_correct(toy, monkeypatch, kind, traced):
    run = toy_run(kind, traced)
    line, checks = drive(monkeypatch, run)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["checks"]) == set(run.workload["limits"])
    assert checks[-1].startswith("check ")
    e2e = {"train_resident": "train_samples_per_s",
           "serve": "serve_img_per_s"}[kind]
    if not traced:
        assert {"setup_s", e2e} <= set(line["metrics"])
    model = harness.program_model(run, harness.seeded_weights(run), False)
    assert isinstance(model, ToyFusion)
    assert set(dict(model.named_parameters())) == set(dict(
        reference.PlainFusion(run.cfg).named_parameters()))
    assert flops.forward_flops(run.cfg) == 2 * 16 * 192 * 48 + 2 * (
        48 + 128) * 50


@pytest.mark.parametrize("kind,fault", [
    ("train_resident", "state_unchanged"), ("train_resident", "half_batch"),
    ("train_resident", "answer_altered"), ("serve", "answer_altered")])
def test_a_test_only_trunk_is_held_by_its_faults(toy, monkeypatch, kind,
                                                 fault):
    line, _ = drive(monkeypatch, toy_run(kind), fault)
    assert line["correct"] is False
    assert [k for k, v in line["checks"].items() if v["value"] > v["limit"]]


def test_the_trunk_module_gives_the_init_rule(toy):
    run = toy_run("train_resident")
    w = harness.seeded_weights(run)
    # its own rule: std 0.02; the generic one would give 1/sqrt(48)
    assert float(w["toy.bias_table"].std()) == pytest.approx(0.02, rel=0.1)
    assert float(w["toy.proj.weight"].std()) == pytest.approx(
        1 / math.sqrt(192), rel=0.1)


def test_an_unknown_trunk_names_the_file_to_add():
    cfg = {**tiny_config("vit_b16_fusion_mt"), "trunk": "swin"}
    run = harness.Run("swin.train_resident", {"batch": 4}, cfg, 7, 0.0,
                      False, torch.device("cpu"), time.perf_counter())
    match = "add benchmarks/portbench/trunks/swin.py"
    with pytest.raises(ModuleNotFoundError, match=match):
        harness.program_model(run, {}, True)
    with pytest.raises(ModuleNotFoundError, match=match):
        reference.PlainFusion(cfg)
    with pytest.raises(ModuleNotFoundError, match=match):
        flops.forward_flops(cfg)
    with pytest.raises(ModuleNotFoundError, match=match):
        trunks.get(cfg)


def _rule_before(name, shape, cfg):
    """inputs._scale as it was before the trunk modules gave their rules."""
    g = cfg.get("init_residual_gamma")
    if g is not None and name.endswith("bn3.weight"):
        return g, 0.1 * g
    if name.endswith(("cls_token", "pos_embed")):
        return 0.0, 0.02
    if len(shape) >= 2:
        return 0.0, 1.0 / math.sqrt(math.prod(shape[1:]))
    if name.endswith("weight"):
        return 1.0, 0.1
    return 0.0, 0.1


def _shapes(cfg):
    with torch.device("meta"):
        return inputs.parameter_shapes(reference.PlainFusion(cfg))


@pytest.mark.parametrize("name", ["vit_b16_fusion_mt", "resnet50_fusion_mt"])
def test_the_draws_are_those_before_the_lookup(name):
    full = harness.load_json(BENCH / "configs" / f"{name}.json")
    for leaf, shape in _shapes(full):
        assert inputs._scale(leaf, shape, full, trunks.get(full)) == \
            _rule_before(leaf, shape, full), leaf
    # the draw itself, bit for bit, at the tiny sizes
    cfg, seed = tiny_config(name), 2**31 + 5
    shapes = _shapes(cfg)
    got = inputs.make_weights(shapes, seed, "cpu", cfg)
    flat = torch.randn(sum(math.prod(s) for _, s in shapes),
                       generator=inputs.generator(seed, "weights", "cpu"))
    at = 0
    for leaf, shape in shapes:
        n = math.prod(shape)
        offset, std = _rule_before(leaf, shape, cfg)
        assert torch.equal(got[leaf], flat[at:at + n].view(shape).mul(std)
                           .add(offset)), leaf
        at += n
