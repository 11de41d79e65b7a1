"""The plain reference against a brute-force HDBSCAN* (the Java reference's
top-down formulation: remove the tree's edges heaviest level first, split
clusters by breadth-first search), and against the port's CPU fit."""

import numpy as np
import pytest
import torch

from portbench import compare, data, reference
from portbench.data import gauss, skin_grid


def brute_hdbscan(x: np.ndarray, min_pts: int, mcs: int) -> tuple:
    """(core distances, sorted tree weights, flat labels) by brute force."""
    n = len(x)
    d = np.sqrt(((x[:, None, :] - x[None, :, :]) ** 2).sum(-1))
    core = np.sort(d, axis=1)[:, min_pts - 2]  # the (min_pts - 1)-th, self included
    mrd = np.maximum(d, np.maximum(core[:, None], core[None, :]))
    # Prim
    in_tree = np.zeros(n, bool)
    best = np.full(n, np.inf)
    frm = np.zeros(n, int)
    in_tree[0] = True
    best[:] = mrd[0]
    edges = []
    for _ in range(n - 1):
        j = int(np.argmin(np.where(in_tree, np.inf, best)))
        edges.append((frm[j], j, best[j]))
        in_tree[j] = True
        closer = mrd[j] < best
        best = np.where(closer, mrd[j], best)
        frm = np.where(closer, j, frm)
    w = np.array([e[2] for e in edges])
    # top-down removal, one weight level at a time
    cluster = np.ones(n, int)  # current cluster of each point, 0 once it left
    last = np.ones(n, int)
    parent, birth, stab, kids = {1: 0}, {1: np.inf}, {1: 0.0}, {1: False}

    def detach(c, count, lv):
        inv_b = 0.0 if np.isinf(birth[c]) else 1.0 / birth[c]
        stab[c] += count * (1.0 / lv - inv_b)

    alive = list(edges)
    for lv in sorted(set(w.tolist()), reverse=True):
        hit = {cluster[a] for a, b, ww in alive if ww == lv} - {0}
        alive = [e for e in alive if e[2] < lv]
        adj = {}
        for a, b, _ in alive:
            adj.setdefault(a, []).append(b)
            adj.setdefault(b, []).append(a)
        for c in sorted(hit):
            members = set(np.nonzero(cluster == c)[0].tolist())
            comps, seen = [], set()
            for p in sorted(members):
                if p in seen:
                    continue
                comp, stack = [], [p]
                seen.add(p)
                while stack:
                    q = stack.pop()
                    comp.append(q)
                    for r in adj.get(q, []):
                        if r in members and r not in seen:
                            seen.add(r)
                            stack.append(r)
                comps.append(comp)
            big = [cp for cp in comps if len(cp) >= mcs]
            for cp in comps:
                if len(cp) < mcs or not big:
                    last[cp] = c
                    cluster[cp] = 0
                    detach(c, len(cp), lv)
            if len(big) >= 2:
                for cp in big:
                    new = max(parent) + 1
                    parent[new], birth[new], stab[new], kids[new] = c, lv, 0.0, False
                    kids[c] = True
                    detach(c, len(cp), lv)
                    cluster[cp] = new
                    last[cp] = new
    prop, win = {c: 0.0 for c in parent}, {c: [] for c in parent}
    for c in sorted(parent, reverse=True):
        if c == 1:
            continue
        p = parent[c]
        if not kids[c] or stab[c] >= prop[c]:
            prop[p] += stab[c]
            win[p].append(c)
        else:
            prop[p] += prop[c]
            win[p].extend(win[c])
    selected = set(win[1])

    def sel(c):
        while c > 0:
            if c in selected:
                return c
            c = parent[c]
        return 0

    return core, np.sort(w), np.array([sel(c) for c in last])


@pytest.mark.parametrize("kind,seed", [("grid", 1), ("grid", 2), ("gauss", 3), ("gauss", 4)])
def test_reference_equals_brute_force(kind, seed):
    rng = data.rng_for(seed, 0)
    c, wt = gauss.gauss_mixture(3 if kind == "grid" else 4, 3, 8.0, 1.0, seed)
    x = gauss.make_gauss(300, c * (2.0 if kind == "grid" else 1.0), wt, 1.0, rng)[0]
    if kind == "grid":  # integer codes: exact squared distances, many exact ties
        x = np.round(2.0 * x)
    min_pts, mcs = 5, 20
    core, w, labels = brute_hdbscan(x, min_pts, mcs)
    ref = reference.fit(x, min_pts, mcs, [torch.device("cpu")])
    if kind == "grid":  # exact squares: the float32 roots of the brute force's values
        core, w, tol = core.astype(np.float32), w.astype(np.float32), 0.0
    else:
        tol = 1e-5
    assert compare.rel_gap(ref["core"], core) <= tol
    assert compare.rel_gap(np.sort(ref["mst"][2]), w) <= tol
    assert len(set(labels.tolist())) > 1
    assert compare.label_rows(ref["labels"], labels) == 0


@pytest.mark.parametrize("config", ["skin", "hepmass28"])
def test_reference_equals_port_cpu_fit(config):
    from hdbscan_tpu_torch import HDBSCANParams
    from hdbscan_tpu_torch.models import exact

    from portbench import spec

    cfg = dict(spec._json("configs", config), n=2000, min_cluster_size=40)
    x = data.generate(cfg, 99, 0)
    res = exact.fit(x, HDBSCANParams(min_points=cfg["min_points"], min_cluster_size=40,
                                     **cfg["params"]), device="cpu")
    n, _ = reference.judge_fit(x, res.labels, res.core_distances, res.mst, cfg["min_points"],
                               40, [torch.device("cpu")])
    assert n["label_rows"] == 0
    limit = 0.0 if config == "skin" else 1e-4
    assert n["core_gap"] <= limit and n["mst_gap"] <= limit and n["mst_excess"] <= limit
    # the reference's own tree, judged the same way
    ref = reference.fit(x, cfg["min_points"], 40, [torch.device("cpu")])
    m, _ = reference.judge_fit(x, ref["labels"], ref["core"], ref["mst"], cfg["min_points"],
                               40, [torch.device("cpu")])
    assert m["label_rows"] == 0 and m["mst_excess"] <= limit


@pytest.mark.parametrize("seed", [1, 2])
def test_certificate_refuses_a_tree_that_is_not_minimum(seed):
    rng = data.rng_for(seed, 0)
    x = np.round(4 * rng.normal(size=(400, 3)))
    pts = [reference.Points(x, "cpu")]
    c2 = reference.core_distances_sq(pts, 5)
    u, v, w = reference.boruvka_mst(pts, c2)
    assert reference.certify(pts, c2, u, v, reference.tree_weights(pts, c2, u, v)) == 0.0
    # swap the lightest edge for the heaviest edge that reconnects its two sides
    order = np.argsort(w)
    k = order[0]
    keep = np.ones(len(u), bool)
    keep[k] = False
    side = reference._components(400, u[keep], v[keep])
    a = np.nonzero(side == side[u[k]])[0]
    b = np.nonzero(side != side[u[k]])[0]
    d = ((x[a][:, None, :] - x[b][None, :, :]) ** 2).sum(-1)
    i, j = np.unravel_index(np.argmax(d), d.shape)
    u2, v2 = np.append(u[keep], a[i]), np.append(v[keep], b[j])
    assert reference.certify(pts, c2, u2, v2, reference.tree_weights(pts, c2, u2, v2)) > 0.1
    assert reference.tree_weights(pts, c2, u[keep], v[keep]) is None


def test_reference_predict_matches_port_predictor():
    from hdbscan_tpu_torch import HDBSCANParams
    from hdbscan_tpu_torch.models import exact
    from hdbscan_tpu_torch.serve.artifact import ClusterModel
    from hdbscan_tpu_torch.serve.predict import Predictor

    x = skin_grid.skin_grid(3000, 3, data.rng_for(5, 0))
    params = HDBSCANParams(min_points=16, min_cluster_size=60)
    res = exact.fit(x, params, device="cpu")
    q = data.novel_queries(x, 500, data.rng_for(5, 1))
    labels, prob, _ = Predictor(ClusterModel.from_fit_result(res, x, params), backend="fused",
                                device="cpu").predict(q)
    ref = reference.fit(x, 16, 60, [torch.device("cpu")])
    mapping = compare.matching(res.labels, ref["labels"])
    rl, rp = reference.predict(ref, x, q, 16)
    got = compare.predict_numbers(labels, prob, rl, rp, mapping)
    assert got["label_rows"] == 0 and got["prob_gap"] == 0.0
