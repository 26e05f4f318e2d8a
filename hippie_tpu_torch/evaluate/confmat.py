"""Confusion-matrix heatmap figure (reference: hippie/utils.py:10-39).

Counterpart of hippie_tpu/evaluate/confmat.py: a row-normalized seaborn
heatmap annotated "norm\\n(count)", titled "{k} neighbors"; returns the
closed figure. matplotlib and seaborn are imported when it is called, so the
rest of the package runs without them.
"""

from __future__ import annotations

import numpy as np


def make_confmat(cm, label_names, best_neighbors):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import seaborn as sns

    cm = np.asarray(cm)
    normalized_cm = cm / cm.sum(axis=1, keepdims=True)
    annotations = np.array(
        [f"{frac:.2f}\n({count})" for frac, count in zip(normalized_cm.ravel(), cm.ravel())],
        dtype=object,
    ).reshape(cm.shape)

    fig, ax = plt.subplots()
    sns.heatmap(normalized_cm, annot=annotations, fmt="", cmap="Blues",
                xticklabels=label_names, yticklabels=label_names, ax=ax)
    ax.set_xticklabels(label_names, rotation=45, ha="right")
    ax.set_yticklabels(label_names, rotation=0)
    ax.set_title(f"{best_neighbors} neighbors")
    plt.close(fig)
    return fig
