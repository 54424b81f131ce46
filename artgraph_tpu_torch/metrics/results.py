"""Results-CSV emission in the reference repository's schema.

Port of artgraph_tpu/metrics/results.py. Schema of the reference's
committed artifacts (results/with_class_weights/baseline_genre/*):
  results.csv            — ',0' header; rows accuracy, top-2-accuracy,
                           macro-f1, macro-precision, macro-recall
  precisions_recalls.csv — per-class rows: name,precisions,recalls,f1
  confusion_matrix.csv   — index_name + class-name columns
  true_preds.csv         — ',true,prediction' rows
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


def write_results(out_dir: str, summary: Dict[str, object],
                  suffix: str = "") -> None:
    """Write the four reference-schema CSVs for one evaluated task.

    `suffix` distinguishes multitask outputs, e.g. '_style' / '_genre'
    (matching results_style.csv etc. in the reference tree).
    """
    import pandas as pd

    os.makedirs(out_dir, exist_ok=True)

    headline = pd.Series(
        {
            "accuracy": summary["accuracy"],
            "top-2-accuracy": summary["top-2-accuracy"],
            "macro-f1": summary["macro-f1"],
            "macro-precision": summary["macro-precision"],
            "macro-recall": summary["macro-recall"],
        },
        name=0,
    )
    headline.to_frame().to_csv(os.path.join(out_dir, f"results{suffix}.csv"))

    per_class = summary["per_class"]
    num_classes = len(per_class["precision"])
    names: Optional[list] = summary.get("class_names")
    index = names if names else list(range(num_classes))
    pd.DataFrame(
        {
            "precisions": per_class["precision"],
            "recalls": per_class["recall"],
            "f1": per_class["f1"],
        },
        index=index,
    ).to_csv(os.path.join(out_dir, f"precisions_recalls{suffix}.csv"))

    cm = np.asarray(summary["confusion_matrix"])
    cm_df = pd.DataFrame(cm, index=index, columns=index)
    cm_df.index.name = "index_name"
    cm_df.to_csv(os.path.join(out_dir, f"confusion_matrix{suffix}.csv"))

    pd.DataFrame(
        {"true": summary["y_true"], "prediction": summary["y_pred"]}
    ).to_csv(os.path.join(out_dir, f"true_preds{suffix}.csv"))
