"""The port's tensor parallelism (artgraph_tpu_torch/parallel/mesh.py:
create_mesh(data, model), shard_params(rules=), ColumnParallelLinear,
gather_params) against one process and against the JAX package's TP step,
on the CPU.

The model is NewMultiModalMultiTask(128, {style: 32, genre: 18}) at dropout
0 with its ResNet50 cut to one bottleneck a stage at full widths (as
tests/test_torch_trajectory.py cuts it), placed by the driver entry's
`head_param_rules` (__graft_entry__.py:122-131 in torch's layout: both
classifier Linears split on their output dimension over `model`). Four
gloo ranks in one spawn (one thread each, a `file://` rendezvous under
tmp_path) run every case; the rank body lives in this module, which
imports torch and numpy only at module level, and writes .npz files:

  * tp64: a data 2 x model 2 mesh, f64, two SGD steps at 32 px on global
    batches of 8, through the Trainer: against the one process, the
    logits, losses, every gathered gradient, the gathered parameters and
    the BN running statistics at rtol 1e-10 (the order of the sums only);
    SGD, not Adam, whose sign-like steps would hide a gradient off by an
    axis size;
  * rules1 / dp: the same run over a data 4 x model 1 mesh with the rules,
    and over the data-parallel mesh without them: bit for bit equal;
  * tp32: the data 2 x model 2 mesh in f32, one Adam(3e-4) step at 64 px
    on a batch of 8, against the JAX TP step (__graft_entry__.py:150-169,
    its param_rules, on a 2 x 2 virtual CPU mesh) from the same weights,
    carried by state_dict_from_flax, at the port's one-step ResNet bounds
    (tests/test_torch_resnet.py): the loss at rtol 1e-5, the running
    statistics at rtol = atol = 1e-4, each parameter's Adam first moment
    (0.1 x its gradient, the step's update before Adam's normalization)
    at relative L2 2e-2, and every updated parameter within two Adam
    steps (2 x 3e-4) of JAX's.
"""
import functools
import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from artgraph_tpu_torch.cli._common import multi_task_loss
from artgraph_tpu_torch.cli.train_new_multimodal_multitask import \
    image_and_embeddings
from artgraph_tpu_torch.models import NewMultiModalMultiTask, ResNet50, heads
from artgraph_tpu_torch.parallel.mesh import (ColumnParallelLinear, DataMesh,
                                              batch_sharding, create_mesh,
                                              gather_params,
                                              global_batch_array,
                                              shard_params, spawn)
from artgraph_tpu_torch.train.trainer import Trainer, adam

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from __graft_entry_torch__ import head_param_rules  # noqa: E402

STAGES = (1, 1, 1, 1)
EMB = 128
CLASSES = {"style": 32, "genre": 18}
B = 8
LR_SGD, LR_ADAM = 0.05, 3e-4
TIMEOUT = 300.0
F64 = dict(rtol=1e-10, atol=1e-12)
CPU = torch.device("cpu")


def cut_trunk() -> None:
    heads.ResNet50 = functools.partial(ResNet50, stage_sizes=STAGES)


def batches(seed: int, px: int, steps: int) -> list:
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (B, px, px, 3), dtype=np.uint8),
             rng.normal(size=(B, EMB)).astype(np.float32),
             rng.normal(size=(B, EMB)).astype(np.float32),
             np.stack([rng.integers(0, 32, B), rng.integers(0, 18, B)],
                      1).astype(np.int32),
             np.ones(B, np.float32)) for _ in range(steps)]


def make_model(state: dict, dtype) -> torch.nn.Module:
    model = NewMultiModalMultiTask(EMB, CLASSES, dropout=0.0, dtype=dtype)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in state.items()}, strict=True)
    return model.to(dtype)


def gathered(model, mesh, of) -> dict:
    """of(parameter) for every parameter, whole: a ColumnParallelLinear's
    blocks gathered over `model`."""
    split = {n for n, m in model.named_modules()
             if isinstance(m, ColumnParallelLinear)}
    out = {}
    for name, p in model.named_parameters():
        t = of(p)
        if name.rpartition(".")[0] in split:
            t = global_batch_array(t, mesh.model)
        out[name] = t.detach().numpy().copy()
    return out


def run(state: dict, dtype, steps: list, opt, mesh=None, rules=None) -> dict:
    """The Trainer's steps on `steps` (global batches) from `state`, over
    `mesh` placed by `rules` (one process without a mesh); every result
    whole, as numpy."""
    model = make_model(state, dtype)
    if mesh is not None:
        shard_params(model, mesh, rules)
    loss_fn = multi_task_loss(None, None, 0.5, 0.5)
    logits = []

    def compute_loss(outputs, batch):
        logits.append([o.detach() for o in outputs])
        return loss_fn(outputs, batch)

    trainer = Trainer(model, opt, compute_loss, transform_type="resnet",
                      device="cpu", mesh=mesh,
                      forward_inputs=image_and_embeddings)
    out = {}
    for i, batch in enumerate(steps):
        local = batch if mesh is None else batch_sharding(mesh, batch)
        loss, _ = trainer.train_step(trainer.to_device(local))
        out[f"loss{i}"] = loss.numpy()
        for head, o in zip(("style", "genre"), logits[-1]):
            out[f"logits{i}_{head}"] = (
                o if mesh is None else global_batch_array(o, mesh)).numpy()
    for name, g in gathered(model, mesh, lambda p: p.grad).items():
        out[f"grad/{name}"] = g
    state_after = (model.state_dict() if mesh is None
                   else gather_params(model, mesh))
    for k, v in state_after.items():
        out[f"state/{k}"] = v.numpy().copy()
    if isinstance(trainer.optimizer, torch.optim.Adam):
        moments = gathered(model, mesh,
                           lambda p: trainer.optimizer.state[p]["exp_avg"])
        for name, m in moments.items():
            out[f"exp_avg/{name}"] = m
    return out


def sgd(params):
    return torch.optim.SGD(params, lr=LR_SGD)


def _tp_rank(_, out_dir: str, state_path: str) -> None:
    """Every case on this rank (module docstring)."""
    cut_trunk()
    state = dict(np.load(state_path))
    results = {}
    cases = (("tp64", torch.float64, batches(0, 32, 2), sgd, (2, 2),
              head_param_rules),
             ("rules1", torch.float64, batches(0, 32, 2), sgd, (4, 1),
              head_param_rules),
             ("dp", torch.float64, batches(0, 32, 2), sgd, (4,), None),
             ("tp32", torch.float32, batches(1, 64, 1), adam(LR_ADAM),
              (2, 2), head_param_rules))
    for name, dtype, steps, opt, layout, rules in cases:
        mesh = create_mesh(*layout)
        for k, v in run(state, dtype, steps, opt, mesh, rules).items():
            results[f"{name}/{k}"] = v
    np.savez(os.path.join(out_dir, f"rank{dist.get_rank()}.npz"), **results)


def _jax_model():
    import jax.numpy as jnp

    from artgraph_tpu.models import NewMultiModalMultiTask as JaxModel

    return JaxModel(emb_size=EMB, num_classes=CLASSES, dropout=0.0,
                    dtype=jnp.float32)


def _cut_jax_trunk(monkeypatch) -> None:
    import artgraph_tpu.models.heads as jax_heads
    from artgraph_tpu.models.resnet import ResNet50 as JaxResNet50

    monkeypatch.setattr(jax_heads, "ResNet50",
                        functools.partial(JaxResNet50, stage_sizes=STAGES))


@pytest.fixture(scope="module")
def jax_variables():
    """The JAX model's initial variables (PRNGKey(0), as the JAX dry run)
    with the cut trunk."""
    import jax
    import jax.numpy as jnp

    from artgraph_tpu.ops.preprocess import normalize_images

    mp = pytest.MonkeyPatch()
    try:
        _cut_jax_trunk(mp)
        images, emb = batches(1, 64, 1)[0][:2]
        return jax.device_get(_jax_model().init(
            jax.random.PRNGKey(0), normalize_images(jnp.asarray(images[:1])),
            jnp.asarray(emb[:1]), jnp.asarray(emb[:1]), train=False))
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def tp_runs(jax_variables, tmp_path_factory):
    """Every rank's results (four gloo ranks) and the one process's f64
    run, from the JAX model's initial weights."""
    from artgraph_tpu_torch.checkpointing import state_dict_from_flax

    out = tmp_path_factory.mktemp("tp")
    state = state_dict_from_flax("NewMultiModalMultiTask", jax_variables)
    np.savez(out / "state.npz", **state)
    spawn(_tp_rank, 4, "gloo", init_file=str(out / "rendezvous"),
          timeout=TIMEOUT, args=(str(out), str(out / "state.npz")),
          threads=1)
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(4)]
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(heads, "ResNet50",
                   functools.partial(ResNet50, stage_sizes=STAGES))
        single = run(state, torch.float64, batches(0, 32, 2), sgd)
    finally:
        mp.undo()
    return state, ranks, single


def test_tp_ranks_agree(tp_runs):
    """Every rank holds the same whole results (the gathers are global)."""
    _, ranks, _ = tp_runs
    for other in ranks[1:]:
        assert sorted(other) == sorted(ranks[0])
        for k, v in ranks[0].items():
            np.testing.assert_array_equal(other[k], v, err_msg=k)


def test_tp_step_matches_one_process_f64(tp_runs):
    """data 2 x model 2 against one process: logits, losses, gradients,
    parameters and BN statistics after two SGD steps, with gather_params
    giving the one process's keys and shapes."""
    _, ranks, single = tp_runs
    got = {k[len("tp64/"):]: v for k, v in ranks[0].items()
           if k.startswith("tp64/")}
    assert sorted(got) == sorted(single)
    for k, v in single.items():
        assert got[k].shape == v.shape, k
        if v.dtype.kind in "iu":
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, err_msg=k, **F64)
    assert any(k.startswith("state/class_genre") for k in got)


def test_model_axis_one_is_data_parallelism_bit_for_bit(tp_runs):
    """The rules over a data 4 x model 1 mesh place nothing: the run equals
    the data-parallel one (create_mesh(4), no rules) exactly."""
    _, ranks, _ = tp_runs
    rules1 = {k[len("rules1/"):]: v for k, v in ranks[0].items()
              if k.startswith("rules1/")}
    dp = {k[len("dp/"):]: v for k, v in ranks[0].items()
          if k.startswith("dp/")}
    assert rules1 and sorted(rules1) == sorted(dp)
    for k, v in dp.items():
        np.testing.assert_array_equal(rules1[k], v, err_msg=k)


def _jax_tp_step(variables, batch):
    """__graft_entry__.py:122-169 on a data 2 x model 2 virtual CPU mesh:
    param_rules, put_tree, train_step (adam(3e-4), 0.5 CE + 0.5 CE) at
    dropout 0; returns the new params, batch_stats, Adam's first moments
    and the loss."""
    import jax
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from artgraph_tpu.ops.preprocess import normalize_images
    from artgraph_tpu.parallel.mesh import create_mesh as jax_mesh
    from artgraph_tpu.train import cross_entropy

    mesh = jax_mesh(data=2, model=2, devices=jax.devices()[:4])
    model = _jax_model()
    rng = jax.random.PRNGKey(0)
    params, batch_stats = variables["params"], variables["batch_stats"]
    tx = optax.adam(LR_ADAM)
    opt_state = tx.init(params)

    def param_rules(path, leaf):
        keys = [getattr(p, "key", str(p)) for p in path]
        if "class_style" in keys or "class_genre" in keys:
            if keys[-1] == "kernel" and leaf.ndim == 2:
                return P(None, "model")
            if keys[-1] == "bias":
                return P("model")
        return P()

    def put_tree(tree, rules=None):
        if rules is None:
            return jax.device_put(tree, NamedSharding(mesh, P()))
        flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
        leaves = [jax.device_put(leaf, NamedSharding(mesh, rules(path, leaf)))
                  for path, leaf in flat]
        return jax.tree_util.tree_unflatten(treedef, leaves)

    params = put_tree(params, param_rules)
    batch_stats = put_tree(batch_stats)
    opt_state = put_tree(opt_state, lambda p, l: P())
    data = NamedSharding(mesh, P("data"))
    images_u8, emb_s, emb_g, labels, _ = (jax.device_put(a, data)
                                          for a in batch)

    def train_step(params, batch_stats, opt_state, images_u8, emb_s, emb_g,
                   labels):
        images = normalize_images(images_u8, "resnet")

        def loss_fn(p):
            outs, mut = model.apply(
                {"params": p, "batch_stats": batch_stats}, images, emb_s,
                emb_g, train=True, rngs={"dropout": rng},
                mutable=["batch_stats"])
            loss = (0.5 * cross_entropy(outs[0], labels[:, 0])
                    + 0.5 * cross_entropy(outs[1], labels[:, 1]))
            return loss, mut["batch_stats"]

        (loss, new_stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_stats, opt_state, \
            loss

    with mesh:
        params, stats, opt_state, loss = jax.jit(train_step)(
            params, batch_stats, opt_state, images_u8, emb_s, emb_g, labels)
    return jax.device_get((params, stats, opt_state[0].mu, loss))


def test_tp_step_matches_jax_tp_step_f32(tp_runs, jax_variables,
                                         monkeypatch):
    from artgraph_tpu_torch.checkpointing import state_dict_from_flax

    state0, ranks, _ = tp_runs
    _cut_jax_trunk(monkeypatch)
    params, stats, mu, loss = _jax_tp_step(jax_variables,
                                           batches(1, 64, 1)[0])
    name = "NewMultiModalMultiTask"
    ref = state_dict_from_flax(name, {"params": params,
                                      "batch_stats": stats})
    ref_mu = state_dict_from_flax(name, {"params": mu,
                                         "batch_stats": stats})
    got = {k[len("tp32/"):]: v for k, v in ranks[0].items()
           if k.startswith("tp32/")}
    np.testing.assert_allclose(got["loss0"], float(loss), rtol=1e-5)
    for k, r in ref.items():
        o = got[f"state/{k}"]
        assert o.shape == r.shape, k
        if k.endswith("num_batches_tracked"):
            assert int(o) == 1, k
        elif "running" in k:
            np.testing.assert_allclose(o, r, rtol=1e-4, atol=1e-4, err_msg=k)
        else:
            assert np.abs(o - r).max() <= 2 * LR_ADAM * (1 + 1e-3), k
            m, rm = got[f"exp_avg/{k}"], ref_mu[k]
            assert np.linalg.norm(m - rm) <= \
                2e-2 * np.linalg.norm(rm) + 1e-7, k
            assert not np.array_equal(o, state0[k]), k


def _fake_mesh(model: int) -> DataMesh:
    """A mesh value of one rank of a data 1 x model `model` layout (the
    checks below raise before any collective)."""
    return DataMesh(size=1, rank=0, device=CPU, backend="gloo",
                    model=DataMesh(size=model, rank=0, device=CPU,
                                   backend="gloo", axis_name="model"))


@pytest.mark.parametrize("rule,error,match", [
    # 18 genre rows over a model axis of 4
    (head_param_rules, ValueError, "not divisible"),
    # a spec of the wrong rank, or over the data axis
    (lambda n, t: ("model",) if n == "class_style.1.weight" else None,
     ValueError, "one entry a dimension"),
    (lambda n, t: ("data", None) if n == "class_style.1.weight" else None,
     ValueError, "one entry a dimension"),
    # a split the port does not compute with: a Linear's input dimension,
    # a conv's output channels, a weight without its bias
    (lambda n, t: (None, "model") if n == "class_style.1.weight" else None,
     NotImplementedError, "output dimension"),
    (lambda n, t: ("model", None, None, None) if n == "resnet.0.weight"
     else None, NotImplementedError, "output dimension"),
    (lambda n, t: ("model", None) if n == "class_style.1.weight" else None,
     NotImplementedError, "together"),
])
def test_shard_params_refusals(rule, error, match, monkeypatch):
    monkeypatch.setattr(heads, "ResNet50",
                        functools.partial(ResNet50, stage_sizes=STAGES))
    model = NewMultiModalMultiTask(EMB, CLASSES, dropout=0.0,
                                   dtype=torch.float32)
    with pytest.raises(error, match=match):
        shard_params(model, _fake_mesh(4), rule)


def test_column_parallel_linear_keeps_the_linears_names():
    """The swap keeps parameter names, state_dict keys and the whole
    shapes' metadata; the blocks are the Linear's contiguous rows."""
    linear = torch.nn.Linear(6, 8)
    axis = DataMesh(size=2, rank=1, device=CPU, backend="gloo",
                    axis_name="model")
    col = ColumnParallelLinear(linear, axis)
    assert [n for n, _ in col.named_parameters()] == ["weight", "bias"]
    assert (col.in_features, col.out_features) == (6, 8)
    torch.testing.assert_close(col.weight, linear.weight[4:])
    torch.testing.assert_close(col.bias, linear.bias[4:])
