"""The port's driver entry (__graft_entry_torch__.py), the counterpart of
tests/test_graft_entry.py.

  * dryrun_multichip(4, device="cpu") in a clean subprocess, as
    tests/test_graft_entry.py runs the JAX one: four gloo ranks print the
    six OK lines (the data 2 x model 2 step, then the five data-mesh dry
    runs);
  * entry(device="cpu"): the flagship model's forward from uint8 images,
    finite, and against the JAX entry()'s forward with the JAX weights
    carried by state_dict_from_flax (both in their bf16 default) at
    relative L2 5e-2, the ResNet bound of chip_smoke.py's phase 12;
  * both default to the card: without one they raise before any work;
  * on the card (marked `cuda`): entry() runs the normalize kernel and
    agrees with its plain twin on the card bit for bit.

The module imports torch and numpy only at module level (JAX inside the
tests), so the `cuda` test runs on a host without JAX:
`python -m pytest --noconftest tests/test_torch_graft_entry.py -m cuda`.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import __graft_entry_torch__ as graft  # noqa: E402

OK_LINES = ("dryrun_multichip OK: mesh=data:2xmodel:2 loss=",
            "dryrun shard_map ViT DP step OK: data:4 loss=",
            "dryrun shard_map ViT DP step (fused kernels) OK: data:4 loss=",
            "dryrun shard_map conv-bn bottleneck step OK: data:4 loss=",
            "dryrun sharded epoch-scan OK: data:4 3-batch epoch loss=",
            "dryrun edge-sharded CSR GNN step OK: data:4 loss=")


def test_dryrun_multichip_cpu_in_a_clean_process():
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "_ARTGRAPH_DRYRUN_CHILD")}
    r = subprocess.run(
        [sys.executable, "-c", "import __graft_entry_torch__ as e; "
                               "e.dryrun_multichip(4, device='cpu')"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [ln for ln in r.stdout.splitlines() if " OK" in ln]
    assert len(lines) == len(OK_LINES), r.stdout
    for line, want in zip(lines, OK_LINES):
        assert line.startswith(want), (line, want)
        assert np.isfinite(float(line[len(want):].split()[0])), line


def test_entries_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft.entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft.dryrun_multichip(4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="1 CUDA device"):
        graft.dryrun_multichip(4)


def test_entry_cpu_matches_jax_entry():
    import jax

    import __graft_entry__
    from artgraph_tpu_torch.checkpointing import state_dict_from_flax

    forward, (model, images_u8, emb_s, emb_g) = graft.entry(device="cpu")
    assert images_u8.dtype == torch.uint8
    assert tuple(images_u8.shape) == (8, 224, 224, 3)
    jforward, (variables, jimages, jemb, _) = __graft_entry__.entry()
    np.testing.assert_array_equal(images_u8.numpy(), jimages)
    np.testing.assert_array_equal(emb_s.numpy(), jemb)
    sd = state_dict_from_flax("NewMultiModalMultiTask",
                              jax.device_get(variables))
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()}, strict=True)
    ours = forward(model, images_u8, emb_s, emb_g)
    ref = jax.jit(jforward)(variables, jimages, jemb, jemb)
    for o, r, n in zip(ours, ref, (32, 18)):
        o, r = o.double().numpy(), np.asarray(r, np.float64)
        assert o.shape == r.shape == (8, n)
        assert np.isfinite(o).all()
        assert np.linalg.norm(o - r) <= 5e-2 * np.linalg.norm(r)


@pytest.mark.cuda
def test_entry_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from artgraph_tpu_torch.ops import launches, normalize_images_plain

    forward, args = graft.entry()
    before = launches.COUNTS["normalize_images"]
    logits = forward(*args)
    assert launches.COUNTS["normalize_images"] == before + 1
    model, images_u8, emb_s, emb_g = args
    with torch.no_grad():
        plain = model(normalize_images_plain(images_u8, "resnet"), emb_s,
                      emb_g)
    for o, p in zip(logits, plain):
        assert o.is_cuda and torch.isfinite(o).all()
        torch.testing.assert_close(o, p, rtol=0, atol=0)
