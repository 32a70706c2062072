"""The control of ``correct``: the reference put in the program's place,
with one guarantee of the configuration broken, through the same
comparison.  It has to come out as not correct.

  BFS   the duplicate edges are not merged, so the graph and every search's
        traversed-edge count (the TEPS numerator) differ.
  SSSP  the weight scheme's control weights (``reference(..., control=True)``
        of ``portbench/weights/<scheme>.py``: for ``hash_int`` each weight's
        top 4 bits, the int4 step below 8-bit weights; for ``uniform_f32``
        each weight rounded to bfloat16), so the weights and the distances
        differ.
"""
from __future__ import annotations

import torch

from portbench.bench import compare, inputs
from portbench.reference.graph import build_graph
from portbench.reference.search import (
    bfs_levels, bfs_parents, components, sssp_distances, sssp_parents,
    traversed_edges,
)


def control_outputs(doc: dict, inp: compare.Inputs, n_searches: int) -> compare.Outputs:
    """The control's outputs for the first ``n_searches`` keys, every one
    of them checked."""
    sssp = doc["kernel"] == "sssp"
    g = build_graph(inp.src, inp.dst, inp.num_vertices, dedupe=sssp)
    roots = g.new_from_old[inp.keys.to(torch.int64)]
    w = (inp.weights.reference(g.src, g.dst, seed=inp.seed, doc=inp.doc, control=True)
         if sssp else None)
    m = traversed_edges(g, components(g), roots).cpu().tolist()
    checked = []
    for i in range(n_searches):
        root = int(roots[i])
        if sssp:
            dist = sssp_distances(g, w, root)
            parent = sssp_parents(g, w, dist, root)
            level = inp.weights.encode_distances(dist)
        else:
            level = bfs_levels(g, root)
            parent = bfs_parents(g, level, root)
        checked.append((i, i, parent, level))
    return compare.Outputs(nnz=g.nnz, src=g.src, dst=g.dst, degree=g.degree,
                           weight=inp.weights.encode_weights(w) if sssp else None,
                           search_keys=list(range(n_searches)),
                           search_edges=m[:n_searches], checked=checked,
                           search_roots=[(int(c[2][int(roots[c[1]])]), int(c[3][int(roots[c[1]])]))
                                         for c in checked])


def run_control(doc: dict, weights, seed: int, device, n_searches: int,
                checked: bool = False) -> dict:
    """The compared numbers of the control on the cell's timed graph (or,
    with ``checked``, on the graph a run of ``seed`` checks), its first
    ``n_searches`` keys in an order drawn from ``seed``; ``weights`` is the
    configuration's weight scheme."""
    dev = torch.device(device)
    v = 1 << doc["scale"]
    gseed = inputs.checked_graph_seed(seed) if checked else doc["graph_seed"]
    src, dst = inputs.graph(doc, gseed, dev)
    keys = inputs.search_keys(gseed, src, dst, v, doc["search_keys"])
    order = torch.randperm(len(keys), generator=torch.Generator().manual_seed(seed))
    keys = keys[order.to(dev)]
    inp = compare.Inputs(src=src, dst=dst, num_vertices=v, keys=keys,
                         kernel=doc["kernel"], seed=gseed, weights=weights, doc=doc)
    out = control_outputs(doc, inp, n_searches)
    res = compare.compare(out, inp)
    return {"numbers": res["numbers"], "correct": compare.verdict(res["numbers"])}
