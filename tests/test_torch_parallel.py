"""The port's data parallelism (artgraph_tpu_torch/parallel/mesh.py, the
Trainer's mesh step, the sharded loaders, --data_parallel in the image CLIs)
against the JAX package's shard_map and against the port's own single
process, on the CPU.

The ranks are processes started by parallel.mesh.spawn over gloo, each on
one thread, meeting at a `file://` rendezvous under tmp_path, joined with a
timeout; their bodies live in this module, which imports torch and numpy
only at module level (JAX is imported inside the tests), and they write
.npz files that the test process compares. One spawn a world size runs
every trainer case (the `dp_runs` fixture).

The model is the JAX shard_map test's BN model (tests/test_shardmap_trainer
.py: a 3x3 conv, MixedBatchNorm, ReLU, mean pool, dense) with its class
weights, so the ranks' weight sums differ, on 21 rows in global batches of
8: two full batches and a ragged one of 5 rows, whose masked BatchNorm
step runs on every rank (at 4 ranks one rank's block of it is all
padding). One epoch of SGD; the parameters after it hold each step's
gradient, so a gradient off by the mesh size shows in them.

Tolerances: against the port's single process, in f64, rtol 1e-10 (only
the order of the sums differs); against the JAX Trainer over a 2- and
4-device mesh, in f32, the epoch loss at rtol 1e-5, the correct counts
equal, each parameter's change within 1e-4 of its norm and the BatchNorm
running statistics at rtol 1e-5, atol 1e-6.
"""
import os
import re

import numpy as np
import pytest
import torch
from torch import nn

from artgraph_tpu_torch import config
from artgraph_tpu_torch.cli import _common
from artgraph_tpu_torch.cli._common import single_task_loss
from artgraph_tpu_torch.data.loader import DataLoader
from artgraph_tpu_torch.data.resident import ResidentLoader
from artgraph_tpu_torch.models.resnet import MixedBatchNorm
from artgraph_tpu_torch.parallel.mesh import (DataMesh, batch_sharding,
                                              per_rank, shard_params, spawn)
from artgraph_tpu_torch.train import Trainer

NUM_CLASS = 5
CLASS_WEIGHTS = np.linspace(0.5, 2.0, NUM_CLASS).astype(np.float32)
B = 8          # global batch
ROWS = 21      # two full batches and a ragged one of 5
EVAL_ROWS = 13
LR = 0.1
TIMEOUT = 120.0
F64 = dict(rtol=1e-10, atol=1e-12)


class Rows:
    """n seeded rows of (uint8 8x8 image, int32 label) with get_batch."""

    def __init__(self, n: int, seed: int):
        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 256, (n, 8, 8, 3), dtype=np.uint8)
        self.labels = rng.integers(0, NUM_CLASS, n).astype(np.int32)

    def __len__(self):
        return len(self.labels)

    def get_batch(self, idx):
        idx = np.asarray(idx)
        return self.images[idx], self.labels[idx]


class TinyBN(nn.Module):
    """The JAX test's TinyBNModel: NHWC images -> 3x3 conv (no bias) ->
    MixedBatchNorm -> ReLU -> spatial mean -> dense."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 8, 3, padding=1, bias=False)
        self.bn = MixedBatchNorm(8, apply_dtype=None)
        self.fc = nn.Linear(8, NUM_CLASS)

    def forward(self, x):
        x = self.bn(self.conv(x.permute(0, 3, 1, 2)))
        return self.fc(torch.relu(x).mean((2, 3)))


def port_state(variables) -> dict:
    """The flax TinyBNModel's variables as TinyBN's state_dict (numpy)."""
    p, s = variables["params"], variables["batch_stats"]
    kernel = np.asarray(p["Conv_0"]["kernel"])
    return {"conv.weight": kernel.transpose(3, 2, 0, 1),
            "bn.weight": np.asarray(p["bn"]["scale"]),
            "bn.bias": np.asarray(p["bn"]["bias"]),
            "bn.running_mean": np.asarray(s["bn"]["mean"]),
            "bn.running_var": np.asarray(s["bn"]["var"]),
            "bn.num_batches_tracked": np.zeros((), np.int64),
            "fc.weight": np.asarray(p["Dense_0"]["kernel"]).T,
            "fc.bias": np.asarray(p["Dense_0"]["bias"])}


def make_trainer(state: dict, dtype, mesh=None) -> Trainer:
    model = TinyBN()
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in state.items()}, strict=True)
    model = model.to(dtype)
    return Trainer(model, lambda p: torch.optim.SGD(p, lr=LR),
                   single_task_loss(CLASS_WEIGHTS, "cpu"),
                   transform_type="resnet", device="cpu", mesh=mesh,
                   forward_inputs=lambda img, b: (img.to(dtype),))


def run_trainer(state: dict, dtype, mesh=None, resident: bool = False
                ) -> dict:
    """One training epoch over ROWS rows and a collecting evaluation over
    EVAL_ROWS, from `state`; the results as a flat dict of arrays."""
    trainer = make_trainer(state, dtype, mesh)
    kw = dict(batch_size=B, shuffle=False, mesh=mesh)
    train = (ResidentLoader(Rows(ROWS, 0), device="cpu", **kw) if resident
             else DataLoader(Rows(ROWS, 0), num_workers=1, **kw))
    m = trainer.train_epoch(train)
    out = {f"train_{k}": np.asarray(v) for k, v in m.items()}
    out.update({f"param_{k}": v.detach().numpy().copy()
                for k, v in trainer.model.state_dict().items()})
    if resident:
        return out
    ev, collected = trainer.eval_epoch(
        DataLoader(Rows(EVAL_ROWS, 1), num_workers=1, **kw),
        collect_outputs=True)
    out.update({f"eval_{k}": np.asarray(v) for k, v in ev.items()})
    out["eval_logits"] = np.concatenate([o for o, _ in collected])
    out["eval_labels"] = np.concatenate([r[-1] for _, r in collected])
    return out


def _dp_rank(mesh, out_dir: str, state: dict) -> None:
    """A rank's runs: f64 and f32 through the host loader, f64 through the
    sharded resident loader."""
    results = {}
    for name, dtype, resident in (("f64", torch.float64, False),
                                  ("f32", torch.float32, False),
                                  ("res64", torch.float64, True)):
        for k, v in run_trainer(state, dtype, mesh, resident).items():
            results[f"{name}/{k}"] = v
    np.savez(os.path.join(out_dir, f"rank{mesh.rank}.npz"), **results)


def _jax_model():
    import flax.linen as fnn
    import jax.numpy as jnp

    from artgraph_tpu.models.resnet import MixedBatchNorm as JaxBN

    class TinyBNModel(fnn.Module):
        @fnn.compact
        def __call__(self, x, train: bool = False):
            x = fnn.Conv(8, (3, 3), use_bias=False, dtype=jnp.float32)(x)
            x = JaxBN(apply_dtype=jnp.float32, name="bn")(x, train=train)
            return fnn.Dense(NUM_CLASS)(jnp.mean(fnn.relu(x), axis=(1, 2)))

    return TinyBNModel()


def _jax_trainer(mesh=None):
    import jax.numpy as jnp
    import optax

    from artgraph_tpu.train import cross_entropy
    from artgraph_tpu.train.trainer import Trainer as JaxTrainer
    from artgraph_tpu.train.trainer import accuracy_metrics

    cw = jnp.asarray(CLASS_WEIGHTS)

    def loss(outputs, batch):
        labels, mask = batch[-2], batch[-1]
        return (cross_entropy(outputs, labels, class_weights=cw, mask=mask),
                accuracy_metrics(outputs, labels, mask))

    return JaxTrainer(_jax_model(), optax.sgd(LR), lambda img, b: (img,),
                      loss, mesh=mesh)


@pytest.fixture(scope="module")
def initial():
    """The JAX model's initial variables and their port state_dict."""
    jt = _jax_trainer()
    batch = next(iter(DataLoader(Rows(ROWS, 0), B, num_workers=1)))
    state = jt.init(batch)
    variables = jt.variables(state)
    return variables, port_state(variables)


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"world{w}")
def dp_runs(request, initial, tmp_path_factory):
    """Every rank's results at one world size, and the single process's."""
    world = request.param
    out = tmp_path_factory.mktemp(f"dp{world}")
    spawn(_dp_rank, world, "gloo", init_file=str(out / "rendezvous"),
          timeout=TIMEOUT, args=(str(out), initial[1]), threads=1)
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]
    single = {}
    for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        for k, v in run_trainer(initial[1], dtype).items():
            single[f"{name}/{k}"] = v
    return world, ranks, single


def test_dp_replicas_stay_identical(dp_runs):
    _, ranks, _ = dp_runs
    for other in ranks[1:]:
        assert sorted(other) == sorted(ranks[0])
        for k, v in ranks[0].items():
            np.testing.assert_array_equal(other[k], v, err_msg=k)


def test_dp_train_epoch_matches_single_process(dp_runs):
    """Loss, metrics, examples, BN statistics and every parameter after an
    epoch (two full steps and a ragged masked one) in f64."""
    _, ranks, single = dp_runs
    got = ranks[0]
    for k, v in single.items():
        if not k.startswith("f64/") or k.startswith("f64/eval"):
            continue
        if v.dtype.kind in "iu":
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, err_msg=k, **F64)
    assert got["f64/train_examples"] == ROWS


def test_dp_eval_ragged_gathers_global_order(dp_runs):
    """The ragged eval's gathered outputs and labels, in global batch order,
    and its metrics, against the single process."""
    _, ranks, single = dp_runs
    got = ranks[0]
    assert got["f64/eval_logits"].shape == (EVAL_ROWS, NUM_CLASS)
    np.testing.assert_array_equal(got["f64/eval_labels"],
                                  Rows(EVAL_ROWS, 1).labels)
    for k in ("eval_logits", "eval_loss", "eval_correct", "eval_examples"):
        np.testing.assert_allclose(got[f"f64/{k}"], single[f"f64/{k}"],
                                   err_msg=k, **F64)


def test_dp_resident_epoch_matches_host_loader(dp_runs):
    """Sharded residency through the resident epoch: the same unshuffled
    batches as the host loader's blocks, so the same parameters."""
    _, ranks, _ = dp_runs
    got = ranks[0]
    for k, v in got.items():
        if k.startswith("res64/"):
            twin = "f64/" + k[len("res64/"):]
            np.testing.assert_allclose(v, got[twin], err_msg=k, **F64)


def test_dp_train_epoch_matches_jax_shard_map(dp_runs, initial):
    """The port's f32 ranks against the JAX Trainer's epoch over a mesh of
    the same size (its shard_map step on the full batches, its masked step
    on the ragged one), from the same weights and batches."""
    import jax

    from artgraph_tpu.parallel.mesh import create_mesh

    world, ranks, _ = dp_runs
    variables, state0 = initial
    jt = _jax_trainer(create_mesh(data=world, model=1,
                                  devices=jax.devices()[:world]))
    jstate = jt.state_from_variables(variables)
    batches = list(DataLoader(Rows(ROWS, 0), B, num_workers=1))
    jstate, jm = jt.train_epoch(jstate, batches)
    want = port_state(jax.device_get(jt.variables(jstate)))
    got = ranks[0]
    np.testing.assert_allclose(got["f32/train_loss"], jm["loss"], rtol=1e-5)
    assert got["f32/train_correct"] == jm["correct"]
    assert got["f32/train_examples"] == jm["examples"] == ROWS
    for k, w in want.items():
        o = got[f"f32/param_{k}"]
        if k.endswith("num_batches_tracked"):
            assert o == 3
        elif "running" in k:
            np.testing.assert_allclose(o, w, rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        else:
            d_ours, d_ref = o - state0[k], w - state0[k]
            assert np.linalg.norm(d_ours - d_ref) <= \
                1e-4 * np.linalg.norm(d_ref) + 1e-7, k


# ---------------------------------------------------------------------------
# The sharded loaders, rank by rank (a DataMesh of each rank stands in; the
# loaders read its size and rank only)
# ---------------------------------------------------------------------------

class FakeDS:
    """The JAX test's dataset: images encode their own row index."""

    def __init__(self, n):
        self.n = n
        self.imgs = (np.arange(n)[:, None, None, None]
                     * np.ones((1, 4, 4, 3))).astype(np.float32)
        self.labels = (np.arange(n) % 7).astype(np.int32)

    def __len__(self):
        return self.n

    def get_batch(self, idx):
        idx = np.asarray(idx)
        return self.imgs[idx], self.labels[idx]


def meshes(world: int) -> list:
    return [DataMesh(size=world, rank=r, device=torch.device("cpu"),
                     backend="gloo") for r in range(world)]


def _joined(per_rank_batches) -> list:
    """The ranks' batches concatenated into global ones, in rank order."""
    return [tuple(np.concatenate([np.asarray(b[i]) for b in parts])
                  for i in range(len(parts[0])))
            for parts in zip(*per_rank_batches)]


@pytest.mark.parametrize("n,batch", [(37, 8), (32, 8)])
def test_sharded_residency_matches_host_loader_unshuffled(n, batch):
    """shuffle=False: the ranks' resident batches and masks, joined, are the
    host DataLoader's batches (valid rows) and masks."""
    ds = FakeDS(n)
    host = DataLoader(ds, batch_size=batch, shuffle=False, num_workers=1)
    res = [ResidentLoader(ds, batch_size=batch, shuffle=False, mesh=m,
                          device="cpu") for m in meshes(4)]
    assert all(len(r) == len(host) for r in res)
    joined = _joined([list(r) for r in res])
    assert len(joined) == len(host)
    for hb, rb in zip(host, joined):
        hmask, rmask = hb[-1], rb[-1]
        np.testing.assert_array_equal(hmask, rmask)
        for h, r in zip(hb[:-1], rb[:-1]):
            np.testing.assert_array_equal(h[hmask > 0], r[rmask > 0])


@pytest.mark.parametrize("shuffle", [False, True])
def test_sharded_residency_matches_jax_mesh(shuffle):
    """The ranks' batches joined against the JAX ResidentLoader over a
    4-device mesh (the same per-device rng): equal values under the masks,
    every row once an epoch, two epochs; and the epoch arrays' global valid
    counts."""
    from artgraph_tpu.data.resident import ResidentLoader as JaxResident
    from artgraph_tpu.parallel import create_mesh

    ds = FakeDS(37)
    ref = JaxResident(ds, batch_size=8, shuffle=shuffle, seed=5,
                      mesh=create_mesh(data=4, model=2))
    res = [ResidentLoader(ds, batch_size=8, shuffle=shuffle, seed=5, mesh=m,
                          device="cpu") for m in meshes(4)]
    for _ in range(2):
        want = [tuple(np.asarray(c) for c in b) for b in ref]
        got = _joined([list(r) for r in res])
        seen = []
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g[-1], w[-1])
            keep = g[-1] > 0
            for a, b in zip(g[:-1], w[:-1]):
                np.testing.assert_array_equal(a[keep], b[keep])
            seen += g[0][keep, 0, 0, 0].astype(int).tolist()
        assert sorted(seen) == list(range(37))
    _, mask, valid = res[1].epoch_arrays()
    assert valid == [8, 8, 8, 8, 5] and mask.shape == (5, 2)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_host_loader_is_batch_sharding(world):
    """Each rank's host-loader batch is batch_sharding of the one-process
    loader's global batch, shuffled; the last batch's padding falls to the
    last ranks (a block of padding only at 4 ranks); global_counts are the
    global batches' valid counts."""
    ds = FakeDS(21)
    host = list(DataLoader(ds, 8, shuffle=True, seed=3, num_workers=1))
    for m in meshes(world):
        loader = DataLoader(ds, 8, shuffle=True, seed=3, num_workers=1,
                            mesh=m)
        assert loader.global_counts() == [8, 8, 5]
        for hb, lb in zip(host, loader):
            for h, got in zip(batch_sharding(m, hb), lb):
                np.testing.assert_array_equal(got, h)


def test_mesh_refusals():
    m = meshes(2)[0]
    with pytest.raises(ValueError, match="not divisible"):
        per_rank(7, m)
    with pytest.raises(ValueError, match="not divisible"):
        DataLoader(FakeDS(8), 7, mesh=m)
    with pytest.raises(ValueError, match="not divisible"):
        ResidentLoader(FakeDS(8), 7, mesh=m, device="cpu")
    with pytest.raises(ValueError, match="one entry a dimension"):
        shard_params(TinyBN(), m, rules=lambda name, t: ("data",) * t.dim())
    trainer = make_trainer(port_state_zero(), torch.float32)
    with pytest.raises(ValueError, match="mesh"):
        trainer.train_epoch(DataLoader(FakeDS(8), 4, mesh=m))


def port_state_zero() -> dict:
    return {k: v.numpy() for k, v in TinyBN().state_dict().items()}


# ---------------------------------------------------------------------------
# --data_parallel in the image CLIs
# ---------------------------------------------------------------------------

TINY = dict(patch_size=16, embed_dim=32, depth=2, num_heads=4, mlp_ratio=2.0)


def _cli_args(synthetic_dataset, results, *extra):
    return ["--dataset_path", synthetic_dataset["dataset_dir"],
            "--image_path", synthetic_dataset["image_dir"],
            "--architecture", "vit", "--label", "style", "--batch", "8",
            "--num_workers", "1", "--dropout", "0", "--epochs", "1",
            "--lr", "1e-3", "--device", "cpu", "--results_dir", str(results),
            *extra]


def tiny_vit(dtype=None):
    """A TINY trunk (patch 16) in f32: the rounding of a bf16 one depends
    on the rows a GEMM gets (a rank's 4 against 8), which moves the losses
    by ~5e-4."""
    from artgraph_tpu_torch.models import ViT

    return ViT(**TINY, dtype=torch.float32)


def _tiny_trunk(checkpoints: str) -> None:
    """ViTSingleTask on tiny_vit, checkpoints under `checkpoints` (the port
    reads both when the CLI runs)."""
    from artgraph_tpu_torch.models import heads

    heads.ViT = tiny_vit
    config.CHECKPOINTS_DIR = checkpoints


def _cli_rank(mesh, checkpoints: str, argv: list):
    """A rank of train_baseline --data_parallel on the tiny trunk: the
    launcher's rank body (prints on rank 0 only) after the patch."""
    _tiny_trunk(checkpoints)
    return _common._rank_cli(mesh, "artgraph_tpu_torch.cli.train_baseline",
                             argv)


def _numbers(text: str) -> list:
    """The printed lines' numbers, in order, and the lines' words."""
    lines = [ln for ln in text.splitlines()
             if ln.startswith(("Train loss", "Validation loss",
                               "Test accuracy"))]
    number = r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?"
    words = [re.sub(number, "#", ln) for ln in lines]
    nums = [float(x) for ln in lines for x in re.findall(number, ln)]
    return words, nums


def test_data_parallel_refusals(synthetic_dataset, tmp_path, monkeypatch):
    """More ranks than visible CUDA devices, and a --batch the ranks do not
    divide, are refused before any rank starts; predict and
    generate_projections take no --data_parallel."""
    from artgraph_tpu_torch.cli import (generate_projections, predict,
                                        train_baseline, train_projector)

    started = []
    monkeypatch.setattr(_common, "spawn", lambda *a, **k: started.append(a))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="visible CUDA devices"):
        train_baseline.main(["--data_parallel", "2"])
    with pytest.raises(ValueError, match="not divisible"):
        train_projector.main(["--data_parallel", "3", "--device", "cpu"])
    assert not started
    for cli in (predict, generate_projections):
        with pytest.raises(SystemExit):
            cli.main(["--device", "cpu", "--data_parallel", "1"])


def _cli_runs_rank(mesh, checkpoints: str, out: str, runs: list):
    """Each of `runs` (argv lists) through _cli_rank in turn, in the same
    ranks; rank 0 prints the first run's lines into the file `out`.
    Returns rank 0's results."""
    import contextlib

    with open(out, "w") as f:
        with (contextlib.redirect_stdout(f) if mesh.rank == 0
              else contextlib.nullcontext()):
            first = _cli_rank(mesh, checkpoints, runs[0])
    return [first] + [_cli_rank(mesh, checkpoints, argv)
                      for argv in runs[1:]]


@pytest.fixture(scope="module")
def cli_runs(synthetic_dataset, tmp_path_factory):
    """train_baseline (tiny f32 ViT) in one pair of gloo ranks, four runs:
    --data_parallel 2 at dropout 0 (results in r2), then at dropout 0.4
    with --resume: 2 epochs into resume_a, 1 and then 2 into resume_b."""
    tmp = tmp_path_factory.mktemp("cli")
    dp = ["--data_parallel", "2"]
    runs = [_cli_args(synthetic_dataset, tmp / "r2", *dp)]
    runs += [_cli_args(synthetic_dataset, tmp / f"r{tag}", *dp, "--epochs",
                       str(epochs), "--dropout", "0.4", "--resume",
                       str(tmp / resume))
             for tag, epochs, resume in (("A", 2, "resume_a"),
                                         ("B1", 1, "resume_b"),
                                         ("B", 2, "resume_b"))]
    accs = spawn(_cli_runs_rank, 2, "gloo",
                 init_file=str(tmp / "rendezvous"), timeout=TIMEOUT,
                 args=(str(tmp / "c2"), str(tmp / "dp.out"), runs),
                 threads=1)
    return tmp, accs


def test_train_baseline_data_parallel_matches_single(synthetic_dataset,
                                                      cli_runs, monkeypatch,
                                                      capsys):
    """train_baseline --data_parallel 2 --device cpu (dropout 0) in two gloo
    ranks against the one-process run: the same printed lines (the numbers
    at rtol 1e-4), the same results CSV, one checkpoint of the same name."""
    import pandas as pd

    from artgraph_tpu_torch.cli import train_baseline
    from artgraph_tpu_torch.models import heads

    tmp, accs = cli_runs
    monkeypatch.setattr(config, "CHECKPOINTS_DIR", str(tmp / "c1"))
    monkeypatch.setattr(heads, "ViT", tiny_vit)
    acc1 = train_baseline.main(_cli_args(synthetic_dataset, tmp / "r1"))
    w1, n1 = _numbers(capsys.readouterr().out)
    w2, n2 = _numbers((tmp / "dp.out").read_text())
    assert w1 == w2 and len(w1) >= 3
    np.testing.assert_allclose(n2, n1, rtol=1e-4, atol=1e-6)
    assert accs[0] == pytest.approx(acc1, rel=1e-6)
    t1 = pd.read_csv(tmp / "r1" / "results.csv", index_col=0)
    t2 = pd.read_csv(tmp / "r2" / "results.csv", index_col=0)
    pd.testing.assert_frame_equal(t2, t1, rtol=1e-4)
    assert sorted(os.listdir(tmp / "c2")) == sorted(os.listdir(tmp / "c1"))


def test_train_baseline_data_parallel_resume_is_bit_identical(cli_runs):
    """--data_parallel 2 --resume at dropout 0.4: 1 epoch then 2 against 2
    uninterrupted, the saved models and both ranks' generator states equal
    bit for bit (rank 0 writes every rank's generator state; each rank
    restores its own)."""
    tmp, accs = cli_runs
    assert accs[3] == accs[1]
    a, b = (torch.load(tmp / d / "state.pt", weights_only=False)
            for d in ("resume_a", "resume_b"))
    assert a["epoch"] == b["epoch"] == 2 and len(a["rng"]) == 2
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for x, y in zip(a["rng"], b["rng"]):
        assert torch.equal(x, y)
