"""The port's decoded cache, device-resident loader, prefetching host path
and resident Trainer epochs against the JAX package, on the CPU.

  * the decoded cache (artgraph_tpu_torch/data/cache.py): a cache that the
    JAX `wrap_with_cache` wrote reads in the port with no decode, and the
    other way round; a complete cache is one slice of the memmap, a partial
    one decodes only its missing rows; a Subset shares its base's cache;
  * ResidentLoader: the same epochs as the JAX ResidentLoader (every row,
    padding included, and the masks, exact) and as the port's DataLoader
    (the valid rows and masks exact; the host loader pads with zeros), for
    n in {37, 40}, shuffled, over two epochs; epoch_arrays, device_iter,
    pad_last=False, drop_last and estimate_nbytes equal to JAX's; a budget
    below the dataset raises ResidentCapacityError;
  * the Trainer's resident epoch (`epoch_arrays`, and the per-batch
    `device_iter` stream with epoch_scan=False) against the JAX Trainer's
    epoch scan on a tiny BatchNorm model (the port's MixedBatchNorm; the
    ragged tail a masked step outside the scan) and a tiny dense one (the
    ragged tail inside it), n in {37, 32}, two epochs of Adam, in f64 (jax
    enable_x64; in f32 the two packages' collected logits drift 4e-5 apart
    in two epochs): the epoch losses at rtol 1e-5, the correct counts exact,
    every parameter and BN statistic at rtol 1e-5, atol 1e-6; eval_epoch
    with and without collect_outputs the same way (collected labels exact);
  * the prefetching host path (background thread) gives bit for bit what
    the synchronous loop of train_step gives, and `pipeline` raises its
    producer's error and stops its thread when the consumer stops early;
  * cli.train_baseline --device cpu with --resident_data, with
    --resident_data --no_epoch_scan and with --image_cache (run twice; the
    second run decodes nothing) writes the host-loader run's checkpoint,
    every tensor equal: a tiny ViT, and a ResNet50 of stage sizes
    (1, 1, 1, 1) with ARTGRAPH_CONVBN=1 and a ragged last batch.

Run alone: python -m pytest tests/test_torch_resident.py -q
"""
import functools
import threading

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artgraph_tpu.data.cache import wrap_with_cache as jax_wrap_with_cache
from artgraph_tpu.data.factories import load_dataset as jax_load_dataset
from artgraph_tpu.data.resident import (ResidentLoader as JaxResidentLoader,
                                        estimate_nbytes as jax_nbytes)
from artgraph_tpu.models.resnet import MixedBatchNorm as JaxMixedBatchNorm
from artgraph_tpu.train import cross_entropy as jax_cross_entropy
from artgraph_tpu.train.trainer import (Trainer as JaxTrainer,
                                        accuracy_metrics as jax_accuracy,
                                        adam as jax_adam)
from artgraph_tpu_torch import config
from artgraph_tpu_torch.cli import train_baseline
from artgraph_tpu_torch.data import datasets as port_datasets
from artgraph_tpu_torch.data.cache import wrap_with_cache
from artgraph_tpu_torch.data.datasets import Subset
from artgraph_tpu_torch.data.factories import load_dataset
from artgraph_tpu_torch.data.loader import DataLoader, pipeline
from artgraph_tpu_torch.data.resident import (ResidentCapacityError,
                                              ResidentLoader, estimate_nbytes)
from artgraph_tpu_torch.models import ResNet50, ViT, heads
from artgraph_tpu_torch.models.resnet import MixedBatchNorm
from artgraph_tpu_torch.train import Trainer, adam, cross_entropy
from artgraph_tpu_torch.train.trainer import accuracy_metrics
from test_torch_vit import TINY

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


def _as_numpy(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


# --------------------------------------------------------------------------
# decoded cache
# --------------------------------------------------------------------------

def _no_decode(*_):
    raise AssertionError("decoded an image that the cache holds")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_reads_across_packages(synthetic_dataset, tmp_path, writer,
                                     monkeypatch):
    """A cache written by one package reads in the other with no decode;
    both equal the decoded images."""
    args = (synthetic_dataset["dataset_dir"], synthetic_dataset["image_dir"])
    ref = jax_load_dataset(*args, mode="single_task", label="style")[0]
    ours = load_dataset(*args, mode="single_task", label="style")[0]
    n = len(ours)
    idx = np.arange(n)
    decoded, labels_ref = ref.get_batch(idx)
    if writer == "jax":
        jax_wrap_with_cache(ref, str(tmp_path), "train").get_batch(idx)
        monkeypatch.setattr(port_datasets, "decode_resize_uint8", _no_decode)
        reader = wrap_with_cache(ours, str(tmp_path), "train")
    else:
        wrap_with_cache(ours, str(tmp_path), "train").get_batch(idx)
        import artgraph_tpu.data.datasets as jax_datasets
        monkeypatch.setattr(jax_datasets, "decode_resize_uint8", _no_decode)
        reader = jax_wrap_with_cache(
            jax_load_dataset(*args, mode="single_task", label="style")[0],
            str(tmp_path), "train")
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"train_{config.IMAGE_SIZE}.u8", f"train_{config.IMAGE_SIZE}.valid"]
    assert reader._decoded_cache.complete
    perm = np.random.default_rng(0).permutation(n)
    images, labels = reader.get_batch(perm)
    assert images.dtype == np.uint8 and np.array_equal(images, decoded[perm])
    assert np.array_equal(labels, labels_ref[perm])


def test_cache_partial_then_sliced(synthetic_dataset, tmp_path,
                                   monkeypatch):
    """A partial cache decodes only its missing rows; a complete one is one
    slice of the memmap (no decode); a Subset shares its base's cache."""
    args = (synthetic_dataset["dataset_dir"], synthetic_dataset["image_dir"])
    plain = load_dataset(*args, mode="single_task", label="style")[0]
    ds = wrap_with_cache(load_dataset(*args, mode="single_task",
                                      label="style")[0], str(tmp_path),
                         "train")
    n = len(ds)
    first = np.arange(n // 2)
    ds.get_batch(first)
    decoded = []
    real = port_datasets.decode_resize_uint8
    monkeypatch.setattr(port_datasets, "decode_resize_uint8",
                        lambda path: decoded.append(path) or real(path))
    images, _ = ds.get_batch(np.arange(n))
    assert len(decoded) == n - len(first)
    assert np.array_equal(images, plain.get_batch(np.arange(n))[0])
    monkeypatch.setattr(port_datasets, "decode_resize_uint8", _no_decode)
    assert ds._decoded_cache.complete
    assert np.array_equal(ds.get_batch(np.array([3, 0, 3]))[0],
                          images[[3, 0, 3]])
    # the projector's splits: Subsets of one base dataset share its cache
    base = load_dataset(*args, mode="single_task", label="style")[0]
    a, b = Subset(base, [2, 0]), Subset(Subset(base, [1, 2, 3]), [2])
    assert wrap_with_cache(a, str(tmp_path / "sub"), "train") is a
    cache = base._decoded_cache
    assert wrap_with_cache(b, str(tmp_path / "sub"), "valid") is b
    assert base._decoded_cache is cache
    monkeypatch.setattr(port_datasets, "decode_resize_uint8", real)
    assert np.array_equal(b.get_batch([0])[0], images[[3]])
    assert cache.valid.sum() == 1


# --------------------------------------------------------------------------
# ResidentLoader
# --------------------------------------------------------------------------

class _FakeDS:
    """n rows of 8x8 uint8 images, f32 embeddings and int32 labels."""

    def __init__(self, n):
        rng = np.random.default_rng(n)
        self.images = rng.integers(0, 256, (n, 8, 8, 3), dtype=np.uint8)
        self.emb = rng.normal(size=(n, 4)).astype(np.float32)
        self.labels = (np.arange(n) % 5).astype(np.int32)

    def __len__(self):
        return len(self.labels)

    def get_batch(self, idx):
        idx = np.asarray(idx)
        return self.images[idx], self.emb[idx], self.labels[idx]


def _same(a, b):
    a, b = _as_numpy(a), _as_numpy(b)
    assert a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("n", [37, 40])
def test_resident_epochs_match_jax_and_host_loader(n):
    ds = _FakeDS(n)
    kw = dict(batch_size=8, shuffle=True, seed=3)
    ours = ResidentLoader(ds, device="cpu", **kw)
    ref = JaxResidentLoader(ds, **kw)
    host = DataLoader(ds, num_workers=1, **kw)
    assert len(ours) == len(ref) == len(host) == -(-n // 8)
    for _ in range(2):
        got, want, hosted = list(ours), list(ref), list(host)
        assert len(got) == len(want) == len(hosted) == len(ours)
        for o, r, h in zip(got, want, hosted):
            assert len(o) == len(r) == len(h) == 4
            for a, b in zip(o, r):           # padding included
                _same(a, b)
            k = int(h[-1].sum())
            _same(o[-1], h[-1])
            for a, b in zip(o[:-1], h[:-1]):  # the host pads with zeros
                _same(a[:k], b[:k])
            assert o[0].dtype == torch.uint8 and o[2].dtype == torch.int32
    # epoch_arrays and device_iter: the same schedule as JAX's
    for _ in range(2):
        oi, om, ov = ours.epoch_arrays()
        ri, rm, rv = ref.epoch_arrays()
        assert ov == rv and oi.dtype == torch.int64
        _same(oi, ri)
        _same(om, rm)
        for (ko, bo, o), (kr, br, r) in zip(ours.device_iter(),
                                            ref.device_iter()):
            assert (ko, bo) == (kr, br)
            for a, b in zip(o, r):
                _same(a, b)
    assert estimate_nbytes(ds) == jax_nbytes(ds) == n * (192 + 16 + 4)
    assert ours.nbytes == ref.nbytes


@pytest.mark.parametrize("kw", [dict(pad_last=False), dict(drop_last=True),
                                dict(pad_last=False, drop_last=True)])
def test_resident_pad_last_and_drop_last_match_jax(kw):
    ds = _FakeDS(37)
    ours = ResidentLoader(ds, 8, shuffle=True, seed=5, device="cpu", **kw)
    ref = JaxResidentLoader(ds, 8, shuffle=True, seed=5, **kw)
    assert len(ours) == len(ref)
    for _ in range(2):
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == len(ours)
        for o, r in zip(got, want):
            assert len(o) == len(r)
            for a, b in zip(o, r):
                _same(a, b)
    if not kw.get("pad_last", True):
        with pytest.raises(NotImplementedError):
            ours.epoch_arrays()


def test_resident_budget_raises():
    ds = _FakeDS(10)
    need = estimate_nbytes(ds)
    with pytest.raises(ResidentCapacityError) as err:
        ResidentLoader(ds, 4, hbm_budget_bytes=need - 1, device="cpu")
    assert (err.value.need, err.value.budget) == (need, need - 1)
    ResidentLoader(ds, 4, hbm_budget_bytes=need, device="cpu")
    with pytest.raises(TypeError, match="get_batch"):
        ResidentLoader(object(), 4, device="cpu")


# --------------------------------------------------------------------------
# the Trainer's resident epochs against the JAX Trainer's epoch scan
# --------------------------------------------------------------------------

class _JaxTinyBN(fnn.Module):
    """TinyBNModel of tests/test_epoch_scan.py in `dtype`: conv 3x3 (no
    bias) -> MixedBatchNorm -> ReLU -> spatial mean -> Dense(5)."""
    dtype: jnp.dtype = jnp.float64

    @fnn.compact
    def __call__(self, x, train: bool = False):
        x = fnn.Conv(8, (3, 3), use_bias=False, dtype=self.dtype)(x)
        x = JaxMixedBatchNorm(apply_dtype=self.dtype, name="bn")(x,
                                                                 train=train)
        return fnn.Dense(5, dtype=self.dtype)(jnp.mean(fnn.relu(x), (1, 2)))


class _JaxTinyDense(fnn.Module):
    """TinyDenseModel in `dtype`: spatial mean -> Dense(16) -> ReLU ->
    Dense(5); no batch_stats, so its ragged tail runs inside the scan."""
    dtype: jnp.dtype = jnp.float64

    @fnn.compact
    def __call__(self, x, train: bool = False):
        x = fnn.relu(fnn.Dense(16, dtype=self.dtype)(jnp.mean(x, (1, 2))))
        return fnn.Dense(5, dtype=self.dtype)(x)


class _PortTinyBN(torch.nn.Module):
    """_JaxTinyBN with the port's MixedBatchNorm (NCHW inside)."""

    def __init__(self, dtype=torch.float64):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 8, 3, padding=1, bias=False,
                                    dtype=dtype)
        self.bn = MixedBatchNorm(8, apply_dtype=dtype).to(dtype)
        self.dense = torch.nn.Linear(8, 5, dtype=dtype)

    def forward(self, x):
        x = x.to(self.conv.weight.dtype).permute(0, 3, 1, 2)
        x = torch.relu(self.bn(self.conv(x)))
        return self.dense(x.mean((2, 3)))

    def load_jax(self, variables):
        p, s = variables["params"], variables["batch_stats"]["bn"]
        with torch.no_grad():
            self.conv.weight.copy_(_t(p["Conv_0"]["kernel"]).permute(3, 2, 0,
                                                                     1))
            self.bn.weight.copy_(_t(p["bn"]["scale"]))
            self.bn.bias.copy_(_t(p["bn"]["bias"]))
            self.bn.running_mean.copy_(_t(s["mean"]))
            self.bn.running_var.copy_(_t(s["var"]))
            _load_dense(self.dense, p["Dense_0"])
        return self

    def pairs(self, variables):
        """(name, port tensor, JAX array in the port's layout)."""
        p, s = variables["params"], variables["batch_stats"]["bn"]
        return [
            ("conv", self.conv.weight,
             np.asarray(p["Conv_0"]["kernel"]).transpose(3, 2, 0, 1)),
            ("bn.scale", self.bn.weight, p["bn"]["scale"]),
            ("bn.bias", self.bn.bias, p["bn"]["bias"]),
            ("bn.mean", self.bn.running_mean, s["mean"]),
            ("bn.var", self.bn.running_var, s["var"]),
            *_dense_pairs("dense", self.dense, p["Dense_0"])]


class _PortTinyDense(torch.nn.Module):
    """_JaxTinyDense."""

    def __init__(self, dtype=torch.float64):
        super().__init__()
        self.fc1 = torch.nn.Linear(3, 16, dtype=dtype)
        self.fc2 = torch.nn.Linear(16, 5, dtype=dtype)

    def forward(self, x):
        x = x.to(self.fc1.weight.dtype)
        return self.fc2(torch.relu(self.fc1(x.mean((1, 2)))))

    def load_jax(self, variables):
        with torch.no_grad():
            _load_dense(self.fc1, variables["params"]["Dense_0"])
            _load_dense(self.fc2, variables["params"]["Dense_1"])
        return self

    def pairs(self, variables):
        p = variables["params"]
        return [*_dense_pairs("fc1", self.fc1, p["Dense_0"]),
                *_dense_pairs("fc2", self.fc2, p["Dense_1"])]


def _t(a):
    return torch.from_numpy(np.array(a))


def _load_dense(lin, p):
    lin.weight.copy_(_t(p["kernel"]).t())
    lin.bias.copy_(_t(p["bias"]))


def _dense_pairs(name, lin, p):
    return [(f"{name}.weight", lin.weight, np.asarray(p["kernel"]).T),
            (f"{name}.bias", lin.bias, p["bias"])]


def _port_loss(outputs, batch):
    labels, mask = batch[-2], batch[-1]
    return (cross_entropy(outputs, labels, mask=mask),
            accuracy_metrics(outputs, labels, mask))


def _jax_loss(outputs, batch):
    labels, mask = batch[-2], batch[-1]
    return (jax_cross_entropy(outputs, labels, mask=mask),
            jax_accuracy(outputs, labels, mask))


class _ImageLabels(_FakeDS):
    """(image, label) rows, the tiny models' batches."""

    def get_batch(self, idx):
        idx = np.asarray(idx)
        return self.images[idx], self.labels[idx]


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float64)), tree)


def _trainer_pair(model, n):
    """(dataset, JAX Trainer, its state, the port's Trainer) from the same
    f64 weights (call under jax.enable_x64)."""
    ds = _ImageLabels(n)
    jt = JaxTrainer({"bn": _JaxTinyBN, "dense": _JaxTinyDense}[model](),
                    jax_adam(1e-2), lambda images, batch: (images,),
                    _jax_loss, seed=1)
    v0 = jt.variables(jt.init((ds.images[:1], ds.labels[:1],
                               np.ones(1, np.float32))))
    state = jt.state_from_variables(_f64(v0))
    port = {"bn": _PortTinyBN, "dense": _PortTinyDense}[model]()
    port.load_jax(jt.variables(state))
    pt = Trainer(port, adam(1e-2), _port_loss, device="cpu", seed=1)
    return ds, jt, state, pt


def _close(pt, jt, state, what):
    for name, ours, ref in pt.model.pairs(jt.variables(state)):
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what}: {name}")


@pytest.mark.parametrize("epoch_scan", [True, False])
@pytest.mark.parametrize("model,n", [("bn", 37), ("dense", 37), ("bn", 32),
                                     ("dense", 32)])
def test_resident_trainer_matches_jax_epoch_scan(model, n, epoch_scan):
    with jax.enable_x64(True):
        _resident_trainer_case(model, n, epoch_scan)


def _resident_trainer_case(model, n, epoch_scan):
    ds, jt, state, pt = _trainer_pair(model, n)
    ref_loader = JaxResidentLoader(ds, 8, shuffle=True, seed=3)
    ours_loader = ResidentLoader(ds, 8, shuffle=True, seed=3,
                                 epoch_scan=epoch_scan, device="cpu")
    for epoch in range(2):
        state, m_ref = jt.train_epoch(state, ref_loader)
        m_ours = pt.train_epoch(ours_loader)
        assert m_ours["examples"] == m_ref["examples"] == n
        np.testing.assert_allclose(m_ours["loss"], m_ref["loss"], rtol=RTOL)
        assert m_ours["correct"] == m_ref["correct"]
        _close(pt, jt, state, f"epoch {epoch}")
    assert pt.host_step == jt._host_step == 2 * -(-n // 8)
    if model == "bn":
        assert pt.model.bn.num_batches_tracked.item() == pt.host_step

    e_ref = jt.eval_epoch(state, ref_loader)
    e_ours = pt.eval_epoch(ours_loader)
    np.testing.assert_allclose(e_ours["loss"], e_ref["loss"], rtol=RTOL)
    assert e_ours["correct"] == e_ref["correct"]
    assert e_ours["examples"] == n

    o_ref, c_ref = jt.eval_epoch(state, ref_loader, collect_outputs=True)
    o_ours, c_ours = pt.eval_epoch(ours_loader, collect_outputs=True)
    np.testing.assert_allclose(o_ours["loss"], o_ref["loss"], rtol=RTOL)
    assert len(c_ours) == len(c_ref) == len(ours_loader)
    for (out, rest), (out_r, rest_r) in zip(c_ours, c_ref):
        np.testing.assert_allclose(out, np.asarray(out_r), rtol=RTOL,
                                   atol=ATOL)
        assert len(rest) == len(rest_r) == 1
        assert np.array_equal(rest[0], np.asarray(rest_r[0]))


# --------------------------------------------------------------------------
# the prefetching host path
# --------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["bn", "dense"])
def test_prefetched_epoch_matches_synchronous_steps(model):
    """train_epoch / eval_epoch over a host DataLoader (batches assembled by
    the background thread) against a plain loop of train_step over the
    same batches: equal to the bit."""
    with jax.enable_x64(True):
        ds, _, _, pt = _trainer_pair(model, 37)
        _, _, _, ref = _trainer_pair(model, 37)
    loader = lambda: DataLoader(ds, 8, shuffle=True, seed=4, num_workers=2)
    ours, theirs = loader(), loader()
    for _ in range(2):
        m = pt.train_epoch(ours)
        totals, examples = {}, 0.0
        for batch in theirs:
            dev = ref.to_device(batch)
            n = float(batch[-1].sum())
            loss, metrics = ref.train_step(dev, ragged=n < len(batch[-1]))
            ref._accumulate(totals, loss, metrics, dev[-1])
            examples += n
        want = ref._read(totals, examples)
        assert m == want
    for (name, p), q in zip(pt.model.state_dict().items(),
                            ref.model.state_dict().values()):
        assert torch.equal(p, q), name
    e, col = pt.eval_epoch(loader(), collect_outputs=True)
    e_sync = pt.eval_epoch(loader())
    assert e == e_sync and len(col) == 5
    assert [len(o) for o, _ in col] == [8, 8, 8, 8, 5]


def test_pipeline_raises_and_stops():
    def failing():
        yield 1
        raise ValueError("producer failed")

    got = []
    with pytest.raises(ValueError, match="producer failed"):
        for item in pipeline(failing()):
            got.append(item)
    assert got == [1]

    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield i
            i += 1

    # thread identities, not counts: other tests' loader pools may still be
    # winding down (DataLoader shuts its pool down with wait=False)
    before = set(threading.enumerate())
    stream = pipeline(endless(), size=2)
    assert [next(stream) for _ in range(3)] == [0, 1, 2]
    stream.close()                     # the consumer stops early
    assert [t for t in threading.enumerate()
            if t not in before and t.is_alive()] == []
    assert len(produced) <= 3 + 2 + 1


# --------------------------------------------------------------------------
# the CLI's flags on --device cpu
# --------------------------------------------------------------------------

@pytest.fixture()
def tiny_models(monkeypatch, tmp_path):
    monkeypatch.setattr(heads, "ViT", functools.partial(
        ViT, **dict(TINY, patch_size=16)))
    monkeypatch.setattr(heads, "ResNet50", functools.partial(
        ResNet50, stage_sizes=(1, 1, 1, 1)))
    monkeypatch.setenv("ARTGRAPH_CONVBN", "1")
    return tmp_path


def _run_cli(synthetic_dataset, arch, root, monkeypatch, *extra):
    """train_baseline on the CPU; (test accuracy, the checkpoint's state
    dict)."""
    ckpt = root / "ckpt"
    monkeypatch.setattr(config, "CHECKPOINTS_DIR", str(ckpt))
    acc = train_baseline.main([
        "--dataset_path", synthetic_dataset["dataset_dir"],
        "--image_path", synthetic_dataset["image_dir"],
        "--architecture", arch, "--label", "style", "--batch", "10",
        "--num_workers", "2", "--epochs", "2", "--device", "cpu", *extra])
    path = ckpt / f"style_{arch}_baseline_single-task_checkpoint.pt"
    return acc, torch.load(path, map_location="cpu", weights_only=True)


@pytest.mark.parametrize("mode", ["resident", "resident_no_epoch_scan",
                                  "image_cache"])
@pytest.mark.parametrize("arch", ["vit", "resnet"])
def test_train_baseline_flags_write_the_host_checkpoint(
        synthetic_dataset, tiny_models, monkeypatch, capsys, arch, mode):
    assert synthetic_dataset["counts"]["train"] % 10   # a ragged last batch
    root = tiny_models
    acc, want = _run_cli(synthetic_dataset, arch, root / "host", monkeypatch)
    extra = {"resident": ["--resident_data"],
             "resident_no_epoch_scan": ["--resident_data", "--no_epoch_scan"],
             "image_cache": ["--image_cache", str(root / "cache")]}[mode]
    runs = [_run_cli(synthetic_dataset, arch, root / "ours", monkeypatch,
                     *extra)]
    if mode == "image_cache":
        # the second run reads every split from the cache the first filled
        monkeypatch.setattr(port_datasets, "decode_resize_uint8", _no_decode)
        runs.append(_run_cli(synthetic_dataset, arch, root / "again",
                             monkeypatch, *extra))
        assert sorted(p.name for p in (root / "cache").iterdir()) == sorted(
            f"{s}_{config.IMAGE_SIZE}.{e}" for s in ("train", "valid", "test")
            for e in ("u8", "valid"))
    out = capsys.readouterr().out
    assert out.count("Train loss: ") == 2 * (1 + len(runs))
    for got_acc, got in runs:
        assert got_acc == acc
        assert list(got) == list(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), k


def test_make_loaders_keeps_the_host_loader_over_budget(monkeypatch):
    """--resident_data: a split over the device-memory budget warns and
    keeps the host DataLoader (the JAX package's capacity rule); the rest
    are resident."""
    from artgraph_tpu_torch.cli import _common

    small, big = _FakeDS(6), _FakeDS(40)
    monkeypatch.setattr(_common, "ResidentLoader", functools.partial(
        ResidentLoader, hbm_budget_bytes=estimate_nbytes(small)))
    with pytest.warns(UserWarning, match="'train' exceeds"):
        loaders = _common.make_loaders({"train": big, "valid": small}, 4, 1,
                                       resident=True, epoch_scan=False,
                                       device="cpu")
    assert type(loaders["train"]) is DataLoader
    assert isinstance(loaders["valid"], ResidentLoader)
    assert not loaders["valid"].epoch_scan
