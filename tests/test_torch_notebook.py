"""The port's notebook, notebooks/proposed_model_multitask_torch.ipynb: the
counterpart of tests/test_notebook.py.

  * Tier 1: its code cells play the JAX notebook's roles in the JAX
    notebook's order (imports, ARGS, datasets and loaders, model, Trainer,
    EarlyStopping, the epoch loop, reload and test evaluation), with the
    port's `device` in ARGS and the same printed lines and checkpoint;
  * slow tier: the notebook end to end under nbclient in a fresh kernel,
    paths moved onto the synthetic fixture by the ARTGRAPH_* environment
    variables (artgraph_tpu_torch/config.py), and a parameter cell after
    ARGS: ResNet50, batch 8, 2 epochs, artwork embeddings, the CPU. The
    train loss must fall, both test accuracies print and the checkpoint
    exists.
"""
import json
import os
import re

import numpy as np
import pytest

NOTEBOOKS = os.path.join(os.path.dirname(__file__), os.pardir, "notebooks")
PORT_NB = os.path.join(NOTEBOOKS, "proposed_model_multitask_torch.ipynb")
JAX_NB = os.path.join(NOTEBOOKS, "proposed_model_multitask.ipynb")

# a code cell's role: the statement that marks it (the first that matches)
ROLES = (("reload and test", "reload_state("),
         ("epoch loop", "for epoch in range("),
         ("EarlyStopping", "early_stop = EarlyStopping("),
         ("Trainer", "trainer = Trainer("),
         ("model", "model = NewMultiModalMultiTask("),
         ("datasets and loaders", "loaders = make_loaders("),
         ("ARGS", "ARGS = dict("),
         ("imports", "import "))


def code_cells(path: str) -> list:
    with open(path) as f:
        nb = json.load(f)
    return ["".join(c["source"]) for c in nb["cells"]
            if c["cell_type"] == "code"]


def role(source: str) -> str:
    return next((name for name, mark in ROLES if mark in source), "?")


def test_notebook_has_the_jax_notebooks_cells_in_order():
    want = [name for name, _ in reversed(ROLES)]
    ours = code_cells(PORT_NB)
    assert [role(s) for s in code_cells(JAX_NB)] == want
    assert [role(s) for s in ours] == want
    args, loop, last = ours[1], ours[6], ours[7]
    assert "device='cuda'" in args
    assert "Train loss: " in loop and "trainer.train_epoch(" in loop
    assert "Test style accuracy: {style_acc}; test genre accuracy: " \
        "{genre_acc}" in last
    assert "new-multimodal_multi-task_checkpoint.pt" in ours[5]
    assert "import jax" not in "".join(ours)


@pytest.fixture()
def notebook_env(synthetic_dataset, tmp_path, monkeypatch):
    from artgraph_tpu_torch.data.embeddings import save_embedding

    ds = synthetic_dataset["dataset_dir"]
    rng = np.random.default_rng(5)
    names = {"train": ("gnn_style_embs_graph.pt", "gnn_genre_embs_graph.pt"),
             "validation": ("gnn_style_valid_embs_graph.pt",
                            "gnn_genre_valid_embs_graph.pt"),
             "test": ("gnn_style_test_embs_graph.pt",
                      "gnn_genre_test_embs_graph.pt")}
    for split, count in synthetic_dataset["counts"].items():
        emb_dir = os.path.join(ds, split, "embeddings")
        os.makedirs(emb_dir, exist_ok=True)
        for name in names[split]:
            save_embedding(os.path.join(emb_dir, name),
                           rng.normal(size=(count, 128)).astype(np.float32))
    ck = tmp_path / "checkpoints"
    ck.mkdir()
    monkeypatch.setenv("ARTGRAPH_DATASET_DIR", ds)
    monkeypatch.setenv("ARTGRAPH_IMAGE_DIR", synthetic_dataset["image_dir"])
    monkeypatch.setenv("ARTGRAPH_CHECKPOINTS_DIR", str(ck))
    return {"ck": str(ck)}


@pytest.mark.slow
def test_notebook_executes_and_learns(notebook_env):
    pytest.importorskip("nbclient", reason="runs the notebook under nbclient")
    import nbformat
    from nbclient import NotebookClient

    nb = nbformat.read(PORT_NB, as_version=4)
    args_idx = next(i for i, c in enumerate(nb.cells)
                    if c.cell_type == "code" and "ARGS = dict(" in c.source)
    nb.cells.insert(args_idx + 1, nbformat.v4.new_code_cell(
        "ARGS.update(batch=8, epochs=2, architecture='resnet', "
        "emb_type='artwork', device='cpu')"))
    NotebookClient(nb, timeout=1200, kernel_name="python3").execute()

    text = "\n".join(
        out.get("text", "")
        for cell in nb.cells if cell.cell_type == "code"
        for out in cell.get("outputs", []))
    losses = [float(m) for m in re.findall(r"Train loss: ([0-9.eE+-]+)", text)]
    assert len(losses) == 2, f"expected 2 epochs of output, got: {text[-2000:]}"
    assert losses[1] < losses[0], f"train loss did not decrease: {losses}"
    assert re.search(r"Test style accuracy: [0-9.]+; test genre accuracy:",
                     text), text[-2000:]
    assert os.path.exists(os.path.join(
        notebook_env["ck"], "new-multimodal_multi-task_checkpoint.pt"))
