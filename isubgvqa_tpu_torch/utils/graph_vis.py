"""Scene-graph visualization with included/excluded node coloring.

The port's own copy of ``isubgvqa_tpu/utils/graph_vis.py`` (the
reference's ``utils/graph_vis.py:7-66``): renders the scene graph with
networkx / matplotlib, coloring nodes by whether the mask includes them
(above threshold / discrete 1), and saves the figure under
``<path>/<img_id>/<q_id>/<filename>``.  Both packages are imported
inside the function: the port needs them only to render.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


def save_graph(graph, labels: Dict[int, str], path: str, mask,
               question: str = "", filename: str = "graph.png",
               mode: str = "discrete", img_id: str = "img",
               q_id: str = "q", threshold: float = 0.0,
               print_title: bool = False) -> Optional[str]:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import networkx as nx

    g = nx.DiGraph()
    n = graph.num_nodes
    for i in range(n):
        g.add_node(i)
    for s, d in zip(np.asarray(graph.edge_src), np.asarray(graph.edge_dst)):
        if s != d:
            g.add_edge(int(s), int(d))

    mask = np.asarray(mask).reshape(-1)[:n]
    if mode == "discrete":
        included = mask > threshold
    else:
        included = mask >= np.quantile(mask, 0.5)
    colors = ["#2ca02c" if included[i] else "#d3d3d3" for i in range(n)]

    fig, ax = plt.subplots(figsize=(8, 6))
    try:
        pos = nx.nx_agraph.graphviz_layout(g, prog="neato")
    except Exception:
        pos = nx.spring_layout(g, seed=0)
    nx.draw_networkx(g, pos=pos, ax=ax, node_color=colors,
                     labels={i: labels.get(i, str(i)) for i in range(n)},
                     font_size=8, node_size=600, edge_color="#888888")
    if print_title:
        ax.set_title(question, fontsize=8)
    ax.axis("off")

    out_dir = os.path.join(path, str(img_id), str(q_id))
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, filename)
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return out_path
