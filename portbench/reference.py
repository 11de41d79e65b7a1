"""The plain HDBSCAN* reference: plain PyTorch and numpy, nothing of the port.

It recomputes, from the raw points, what a fit produces, and from the fit,
what serving answers:

- core distances: each row's ``min_pts - 1``-th smallest distance, the row
  itself included (as the port and the Java reference count it);
- a minimum spanning tree of the mutual-reachability graph,
  ``mrd(i, j) = max(core_i, core_j, d(i, j))``, by Borůvka rounds over all
  pairs, row blocks at a time; ties are broken by the edge order (weight,
  lower end, higher end), so each round adds the unique lightest edge of
  every component and the rounds make no cycle;
- the HDBSCAN* hierarchy of that tree: merges of equal weight that touch
  form one multi-way split, a cluster is born where two or
  more parts of ``min_cluster_size`` rows or more split off, stability is
  ``sum rows * (1 / level - 1 / birth)``, excess of mass selects clusters
  with the parent winning ties and the root never selected, and a row takes
  the selected ancestor of the deepest cluster it belonged to (0: noise);
- approximate prediction of query rows against that hierarchy (k nearest
  training rows by (distance, id), attachment level, climb, probability).

Distances are float32 in the dot form over points centred on the integer
nearest their mean (integer codes stay integers, so on the Skin grid every
distance is exact), with TF32 off. ``precision`` selects a control: "tf32"
rounds the product's inputs to TF32's 10-bit mantissa (as a TF32 tensor-core
product would), "bf16" holds the points and distances in bfloat16.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

PRECISIONS = ("f32", "tf32", "bf16")


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 stored mantissa bits), nearest even."""
    b = x.contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    return ((b + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


class Points:
    """The points on one device in the reference's arithmetic: centred,
    in the precision's type, with their squared norms."""

    def __init__(self, data: np.ndarray, device, precision: str = "f32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        data = np.asarray(data, np.float64)
        shift = np.round(data.mean(0)) if len(data) else 0.0
        x = torch.as_tensor(data - shift, dtype=torch.float32, device=device)
        self.precision, self.device, self.shift = precision, torch.device(device), shift
        if precision == "bf16":
            x = x.to(torch.bfloat16)
        self.sq = (x * x).sum(1)
        # The product's operands: under "tf32" rounded as a TF32 tensor-core
        # product rounds them, the norms staying float32.
        self.x = _tf32(x) if precision == "tf32" else x
        self.n = len(data)

    def block(self, rows: torch.Tensor) -> torch.Tensor:
        """(len(rows), n) squared distances of ``rows`` (indices) to every
        point, float32 (bfloat16 under "bf16"), clamped at 0."""
        xb, sb = self.x[rows], self.sq[rows]
        d2 = torch.addmm(self.sq[None, :], xb, self.x.T, beta=1, alpha=-2)
        d2.add_(sb[:, None])
        return d2.clamp_(min=0)

    def to_queries(self, q: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        """Query rows as product operands, with their squared norms."""
        x = torch.as_tensor(np.asarray(q, np.float64) - self.shift, dtype=torch.float32,
                            device=self.device)
        if self.precision == "bf16":
            x = x.to(torch.bfloat16)
        sq = (x * x).sum(1)
        return (_tf32(x) if self.precision == "tf32" else x), sq


def _block_rows(n: int, budget: int = 1 << 29) -> int:
    """Rows a block so that one (rows, n) float32 block holds ~2 GiB."""
    return max(1, min(n, budget // max(n, 1)))


def _parts(n: int, devices: list) -> list:
    """Contiguous row ranges, one a device."""
    step = -(-n // len(devices))
    return [(dev, lo, min(n, lo + step)) for dev, lo in
            zip(devices, range(0, n, step))]


def _on_devices(work, parts: list) -> None:
    """Run ``work(dev, lo, hi)`` for every part, one thread a device."""
    if len(parts) == 1:
        work(*parts[0])
        return
    errors = []

    def run(p):
        try:
            work(*p)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(p,)) for p in parts]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def core_distances_sq(pts: list, min_pts: int) -> np.ndarray:
    """(n,) float64: each row's ``min_pts - 1``-th smallest squared
    distance, self included (``pts``: one :class:`Points` a device)."""
    n = pts[0].n
    k = min(max(min_pts - 1, 1), n)
    out = np.empty(n, np.float64)
    parts = _parts(n, pts)

    def work(p, lo, hi):
        step = _block_rows(n)
        for a in range(lo, hi, step):
            rows = torch.arange(a, min(hi, a + step), device=p.device)
            kth = torch.topk(p.block(rows), k, dim=1, largest=False, sorted=False).values
            out[a:a + len(rows)] = kth.max(1).values.float().cpu().numpy()

    _on_devices(work, parts)
    return out


def _components(n: int, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Component label of every vertex under the edges (u, v)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    g = coo_matrix((np.ones(len(u), np.int8), (u, v)), shape=(n, n)).tocsr()
    return connected_components(g, directed=False)[1].astype(np.int32)


def boruvka_mst(pts: list, core2: np.ndarray) -> tuple:
    """Minimum spanning tree of the mutual-reachability graph: (u, v, w)
    with w = sqrt(max(core_u², core_v², d²(u, v))) as float64 of the
    precision's value. Squared values order the edges as their roots do."""
    n = pts[0].n
    dtype = pts[0].x.dtype
    c2 = {id(p): torch.as_tensor(core2, device=p.device).to(dtype) for p in pts}
    comp = np.arange(n, dtype=np.int32)
    eu, ev, ew = [], [], []
    best_w = np.empty(n, np.float64)
    best_j = np.empty(n, np.int64)
    parts = _parts(n, pts)
    while True:
        comp_dev = {id(p): torch.as_tensor(comp, device=p.device) for p in pts}

        def work(p, lo, hi):
            cd, cc = c2[id(p)], comp_dev[id(p)]
            cols = torch.arange(n, dtype=torch.int32, device=p.device)
            step = _block_rows(n)
            for a in range(lo, hi, step):
                rows = torch.arange(a, min(hi, a + step), device=p.device)
                d2 = p.block(rows)
                torch.maximum(d2, cd[None, :], out=d2)
                torch.maximum(d2, cd[rows][:, None], out=d2)
                d2.masked_fill_(cc[None, :] == cc[rows][:, None], float("inf"))
                val = d2.min(dim=1).values
                idx = torch.where(d2 == val[:, None], cols, n).min(dim=1).values  # lowest tie
                best_w[a:a + len(rows)] = val.float().cpu().numpy()
                best_j[a:a + len(rows)] = idx.cpu().numpy()

        _on_devices(work, parts)
        live = np.isfinite(best_w)
        if not live.any():
            break
        i = np.nonzero(live)[0]
        j = best_j[live]
        w = best_w[live]
        lo, hi = np.minimum(i, j), np.maximum(i, j)
        order = np.lexsort((hi, lo, w))
        first = np.unique(comp[i[order]], return_index=True)[1]
        pick = order[first]
        key = np.unique(lo[pick] * n + hi[pick], return_index=True)[1]
        pick = pick[key]
        eu.append(lo[pick])
        ev.append(hi[pick])
        ew.append(w[pick])
        new = _components(n, np.concatenate(eu), np.concatenate(ev))
        if len(np.unique(new)) == len(np.unique(comp)):
            break
        comp = new
        if len(np.unique(comp)) == 1:
            break
    u = np.concatenate(eu) if eu else np.zeros(0, np.int64)
    v = np.concatenate(ev) if ev else np.zeros(0, np.int64)
    w2 = np.concatenate(ew) if ew else np.zeros(0)
    w = np.sqrt(w2.astype(np.float32)).astype(np.float64)
    if dtype == torch.bfloat16:  # the root of a bfloat16 value, held in bfloat16
        w = torch.sqrt(torch.as_tensor(w2, dtype=torch.bfloat16)).double().numpy()
    return u, v, w


def dendrogram_order(n: int, u, v, w2) -> tuple[np.ndarray, np.ndarray]:
    """Leaf order of the single-linkage dendrogram of the tree (u, v, w2)
    and the merge level between each leaf and the one before it (-inf for
    the first): the tree's path maximum between the leaves at positions
    p < q is then the largest of those levels in (p, q]."""
    order_e = np.lexsort((np.asarray(v), np.asarray(u), np.asarray(w2)))
    parent = list(range(n))
    head = list(range(n))
    tail = list(range(n))
    nxt = [-1] * n
    gap = [-np.inf] * n
    rank = [0] * n

    uu, vv, ww = (np.asarray(a)[order_e].tolist() for a in (u, v, w2))
    for a, b, wt in zip(uu, vv, ww):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        while parent[b] != b:
            parent[b] = parent[parent[b]]
            b = parent[b]
        nxt[tail[a]] = head[b]
        gap[head[b]] = wt
        h, tl = head[a], tail[b]
        if rank[a] < rank[b]:
            a, b = b, a
        rank[a] += rank[a] == rank[b]
        parent[b] = a
        head[a], tail[a] = h, tl
    root = 0
    while parent[root] != root:
        root = parent[root]
    order = np.empty(n, np.int64)
    x, k = head[root], 0
    while x != -1:
        order[k] = x
        k += 1
        x = nxt[x]
    return order, np.asarray(gap)[order]


def tree_weights(pts: list, core2: np.ndarray, u, v) -> np.ndarray | None:
    """Squared mrd of each edge of the tree (u, v) in the reference's
    arithmetic; None when (u, v) is not a spanning tree."""
    n = pts[0].n
    u, v = np.asarray(u, np.int64), np.asarray(v, np.int64)
    if len(u) != n - 1 or n < 2 or len(np.unique(_components(n, u, v))) != 1:
        return None
    p0 = pts[0]
    iu, iv = (torch.as_tensor(a, device=p0.device) for a in (u, v))
    dot = (p0.x[iu].float() * p0.x[iv].float()).sum(1)
    d2 = (p0.sq[iu].float() + p0.sq[iv].float() - 2 * dot).clamp(min=0).to(p0.x.dtype)
    return np.maximum(np.maximum(d2.float().cpu().numpy().astype(np.float64), core2[u]),
                      core2[v])


def certify(pts: list, core2: np.ndarray, u, v, w2: np.ndarray) -> float:
    """Judge the spanning tree (u, v) of squared weights ``w2``
    (:func:`tree_weights`) against every pair of the mutual-reachability
    graph. A spanning tree is minimum exactly when no pair's mrd lies below
    the tree's path maximum between them; the result is the largest relative
    shortfall, ``1 - mrd / path max``, over all pairs (0 for a minimum
    tree). Pairs are taken in the dendrogram's leaf order, row blocks
    against the columns to their right, where the path maximum splits into
    a row term and a column term."""
    n = pts[0].n
    if n < 2:
        return 0.0
    order, gap = dendrogram_order(n, u, v, w2)
    worst = [np.inf]
    step = max(1, min(n, (1 << 29) // n))
    blocks = list(range(0, n, step))

    def work(p, first, _hi):
        dev = p.device
        perm = torch.as_tensor(order, device=dev)
        x, sq = p.x[perm], p.sq[perm]
        c2 = torch.as_tensor(core2[order], device=dev).to(x.dtype)
        g = torch.as_tensor(gap, device=dev).to(torch.float32)
        best = torch.tensor(np.inf, device=dev)
        for r0 in blocks[first::len(pts)]:
            r1 = min(n, r0 + step)
            d = torch.addmm(sq[None, r0:], x[r0:r1], x[r0:].T, beta=1, alpha=-2)
            d.add_(sq[r0:r1, None]).clamp_(min=0)
            torch.maximum(d, c2[None, r0:], out=d)
            torch.maximum(d, c2[r0:r1, None], out=d)
            b = r1 - r0
            # Inside the block, the levels in (x, y] by a running maximum
            # (-inf at y <= x, so those pairs drop out); to its right, the
            # row's levels in (x, r1] and the column's in (r1, y].
            tri = g[r0:r1][None, :].expand(b, b).clone()
            tri.masked_fill_(torch.ones(b, b, dtype=torch.bool, device=dev).tril(), -np.inf)
            path = torch.cummax(tri, 1).values
            if r1 < n:
                row = torch.flip(torch.cummax(torch.flip(g[r0 + 1:r1 + 1], [0]), 0).values, [0])
                col = torch.cat([g.new_full((1,), -np.inf), torch.cummax(g[r1 + 1:], 0).values])
                path = torch.cat([path, torch.maximum(row[:, None], col[None, :])], 1)
            ratio = torch.where(path > 0, d / path, np.inf)
            best = torch.minimum(best, ratio.min())
        with lock:
            worst.append(float(best))

    lock = threading.Lock()
    _on_devices(work, [(p, i, None) for i, p in enumerate(pts)])
    low = min(worst)
    return max(0.0, 1.0 - float(np.sqrt(low))) if np.isfinite(low) else 0.0


def _root(x2: np.ndarray, precision: str) -> np.ndarray:
    if precision == "bf16":
        return torch.sqrt(torch.as_tensor(x2, dtype=torch.bfloat16)).double().numpy()
    return np.sqrt(np.asarray(x2, np.float32)).astype(np.float64)


# ---------------------------------------------------------------------------
# The hierarchy
# ---------------------------------------------------------------------------


def merge_forest(n: int, u, v, w) -> tuple:
    """Single-linkage merge forest of the tree with equal-weight merges that
    touch contracted into one node: (children lists, level of each node,
    size of each node id, root ids). Node ids: points 0..n-1, merges n+t.
    Weights are float32 values, so two that differ differ by far more than
    the 1e-9 within which the port takes them as one level: equal is tied."""
    order = np.lexsort((np.asarray(v), np.asarray(u), np.asarray(w)))
    uu, vv, ww = (np.asarray(a)[order].tolist() for a in (u, v, w))
    parent = list(range(n))
    top = list(range(n))
    rank = [0] * n
    size = [1] * n
    children: list = []
    level: list = []
    for a, b, wt in zip(uu, vv, ww):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        while parent[b] != b:
            parent[b] = parent[parent[b]]
            b = parent[b]
        if a == b:
            continue
        # A tied child's list is taken over, not copied, the longer one
        # kept, so long runs of equal weights stay linear.
        parts = []
        for t in (top[a], top[b]):
            if t >= n and level[t - n] == wt:
                parts.append(children[t - n])
                children[t - n] = None
            else:
                parts.append([t])
        parts.sort(key=len)
        kids = parts[1]
        kids.extend(parts[0])
        children.append(kids)
        level.append(wt)
        size.append(size[top[a]] + size[top[b]])
        if rank[a] < rank[b]:
            a, b = b, a
        rank[a] += rank[a] == rank[b]
        parent[b] = a
        top[a] = n + len(children) - 1
    roots = set()
    for p in range(n):
        r = p
        while parent[r] != r:
            r = parent[r]
        roots.add(top[r])
    return children, level, size, sorted(roots)


def hierarchy(n: int, u, v, w, min_cluster_size: float) -> dict:
    """Condensed tree, excess-of-mass selection and flat labels of the
    spanning tree (u, v, w). Returns a dict of numpy arrays indexed by
    cluster label (1 = root): ``parent``, ``birth``, ``selected``,
    ``sel_anc``, ``eps_min``; by row: ``labels``, ``last`` (deepest cluster),
    ``exit`` (level at which the row left its last cluster)."""
    children, level, size, roots = merge_forest(n, u, v, w)
    parent, birth, stab, alive = [0, -1], [0.0, np.inf], [0.0, 0.0], [0.0, float(n)]
    has_kids = [False, False]
    last = np.ones(n, np.int64)
    exit_lv = np.zeros(n, np.float64)

    def detach(label, count, lv):
        inv = np.inf if lv == 0 else 1.0 / lv
        b = birth[label]
        inv_b = 0.0 if np.isinf(b) else (np.inf if b == 0 else 1.0 / b)
        stab[label] += count * (inv - inv_b)
        alive[label] -= count

    def leaves(node):
        out, stack = [], [node]
        while stack:
            x = stack.pop()
            if x < n:
                out.append(x)
            else:
                stack.extend(children[x - n])
        return out

    def leave(node, label, lv):
        pts = leaves(node)
        last[pts] = label
        exit_lv[pts] = lv
        detach(label, len(pts), lv)

    def born(par, lv, sz):
        label = len(parent)
        parent.append(par)
        birth.append(lv)
        stab.append(0.0)
        alive.append(float(sz))
        has_kids.append(False)
        has_kids[par] = True
        detach(par, sz, lv)
        return label

    stack = []
    if len(roots) == 1:
        stack.append((roots[0], 1))
    else:  # a forest: its trees split off the root at +inf
        big = [r for r in roots if size[r] >= min_cluster_size]
        for r in roots:
            if size[r] < min_cluster_size:
                leave(r, 1, np.inf)
        stack.extend([(big[0], 1)] if len(big) == 1 else
                     [(r, born(1, np.inf, size[r])) for r in big])
    while stack:
        node, label = stack.pop()
        if node < n:
            last[node] = label
            continue
        lv = level[node - n]
        kids = children[node - n]
        big = [c for c in kids if size[c] >= min_cluster_size]
        small = [c for c in kids if size[c] < min_cluster_size]
        for c in (small if big else kids):
            leave(c, label, lv)
        if len(big) >= 2:
            stack.extend((c, born(label, lv, size[c])) for c in big)
        elif len(big) == 1:
            stack.append((big[0], label))

    c = len(parent) - 1
    parent_a = np.asarray(parent, np.int64)
    stab_a = np.asarray(stab)
    prop = np.zeros(c + 1)
    winners: list = [[] for _ in range(c + 1)]
    for label in range(c, 1, -1):  # children before parents; the root last
        par = parent_a[label]
        if not has_kids[label] or stab_a[label] >= prop[label]:
            prop[par] += stab_a[label]
            winners[par].append(label)
        else:
            prop[par] += prop[label]
            winners[par].extend(winners[label])
    selected = np.zeros(c + 1, bool)
    selected[winners[1]] = True
    sel_anc = np.zeros(c + 1, np.int64)
    for label in range(1, c + 1):  # parents before children
        sel_anc[label] = label if selected[label] else (
            sel_anc[parent_a[label]] if parent_a[label] > 0 else 0)
    labels = sel_anc[last]
    eps_min = np.full(c + 1, np.inf)
    m = labels > 0
    np.minimum.at(eps_min, labels[m], exit_lv[m])
    eps_min[~np.isfinite(eps_min)] = 0.0
    return {"parent": parent_a, "birth": np.asarray(birth), "selected": selected,
            "sel_anc": sel_anc, "eps_min": eps_min, "labels": labels, "last": last,
            "exit": exit_lv}


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def fit(data: np.ndarray, min_pts: int, min_cluster_size: float, devices,
        precision: str = "f32") -> dict:
    """The reference fit of ``data``: core distances, the tree and its
    weights, and the hierarchy (see :func:`hierarchy`). ``devices``: the
    devices its row blocks spread over."""
    import time

    t0 = time.perf_counter()
    pts = [Points(data, d, precision) for d in devices]
    core2 = core_distances_sq(pts, min_pts)
    t1 = time.perf_counter()
    u, v, w = boruvka_mst(pts, core2)
    t2 = time.perf_counter()
    core = _root(core2, precision)
    out = hierarchy(len(data), u, v, w, min_cluster_size)
    out.update(core=core, mst=(u, v, w), points=pts[0],
               seconds={"core": t1 - t0, "mst": t2 - t1, "hierarchy": time.perf_counter() - t2})
    return out


def judge_fit(data: np.ndarray, labels, core, mst, min_pts: int, min_cluster_size: float,
              devices) -> tuple[dict, dict | None]:
    """Judge a fit's answer (labels, core distances, spanning tree (u, v,
    w)) on ``data``: (numbers, the reference hierarchy of the tree). The
    core distances are recomputed; the tree is certified minimum over all
    pairs and its weights recomputed; the labels are recomputed from the
    certified tree. Numbers: ``core_gap`` and ``mst_gap`` (widest relative
    gaps of core distances and of the tree's weights), ``mst_excess`` (see
    :func:`certify`), ``label_rows`` (rows in another cluster once the
    clusters are matched one to one)."""
    import time

    from portbench import compare

    t0 = time.perf_counter()
    pts = [Points(data, d) for d in devices]
    core2 = core_distances_sq(pts, min_pts)
    t1 = time.perf_counter()
    u, v, w = mst
    w2 = tree_weights(pts, core2, u, v)
    n = len(data)
    ref_core = _root(core2, "f32")
    numbers = {"core_gap": compare.rel_gap(core, ref_core)}
    if w2 is None:
        numbers.update(mst_excess=float("inf"), mst_gap=float("inf"), label_rows=n)
        return numbers, None
    w_ref = _root(w2, "f32")
    out: dict = {}  # the hierarchy (host) beside the certificate (device)
    th = threading.Thread(target=lambda: out.update(hierarchy(n, u, v, w_ref,
                                                              min_cluster_size)))
    th.start()
    try:
        numbers["mst_excess"] = certify(pts, core2, u, v, w2)
    finally:
        th.join()
    t2 = time.perf_counter()
    numbers.update(mst_gap=compare.rel_gap(w, w_ref),
                   label_rows=compare.label_rows(labels, out["labels"]))
    out.update(core=ref_core, points=pts[0],
               seconds={"core": t1 - t0, "certify_and_hierarchy": t2 - t1})
    return numbers, out


def knn_lists(pts: Points, queries: np.ndarray, k: int, slack: int = 64):
    """(distances (m, k) float64, ids (m, k) int64): each query row's k
    nearest training rows by (distance, id), distances as the precision's
    roots. Rows whose tie at the k-th distance runs past ``slack`` extra
    candidates are sorted whole."""
    xq, sq = pts.to_queries(queries)
    n = pts.n
    take = min(n, k + slack)
    d2 = torch.addmm(pts.sq[None, :], xq, pts.x.T, beta=1, alpha=-2)
    d2.add_(sq[:, None]).clamp_(min=0)
    vals, ids = torch.topk(d2, take, dim=1, largest=False, sorted=True)
    vals, ids = vals.float().cpu().numpy(), ids.cpu().numpy()
    out_d = np.empty((len(queries), k))
    out_i = np.empty((len(queries), k), np.int64)
    for r in range(len(queries)):
        dv, iv = vals[r], ids[r]
        if take < n and dv[-1] <= dv[min(k, take) - 1]:  # the tie runs on: whole row
            row = d2[r].float().cpu().numpy()
            iv = np.lexsort((np.arange(n), row))[:k]
            dv = row[iv]
        else:
            o = np.lexsort((iv, dv))[:k]
            dv, iv = dv[o], iv[o]
        out_d[r], out_i[r] = _root(dv, pts.precision), iv
    return out_d, out_i


def predict(ref: dict, data: np.ndarray, queries: np.ndarray, min_pts: int) -> tuple:
    """(labels, probabilities) of query rows against the reference fit
    ``ref`` of ``data``, with the reference's semantics: the k = min_pts - 1
    nearest training rows, ``eps = min mrd`` over them (first minimum), an
    exact duplicate of the nearest row taking that row's cluster, else the
    deepest ancestor of the exemplar's cluster born at or above ``eps``."""
    k = max(min_pts - 1, 1)
    dist, ids = knn_lists(ref["points"], queries, k)
    core_q = dist[:, min(k, len(data)) - 1]
    mrd = np.maximum(np.maximum(dist, core_q[:, None]), ref["core"][ids])
    j = np.argmin(mrd, axis=1)
    eps = mrd[np.arange(len(queries)), j]
    nbr = ids[np.arange(len(queries)), j]
    dup = np.all(np.asarray(queries, np.float64) == data[ids[:, 0]], axis=1)
    parent, birth = ref["parent"], ref["birth"]
    cluster = np.empty(len(queries), np.int64)
    for r in range(len(queries)):
        if dup[r]:
            cluster[r] = ref["last"][ids[r, 0]]
            continue
        c = ref["last"][nbr[r]]
        while birth[c] < eps[r] and parent[c] > 0:
            c = parent[c]
        cluster[r] = c
    labels = ref["sel_anc"][cluster]
    # float32, as served: the levels are float32 values, so the quotient is
    # the one correctly rounded float32 both sides compute
    em, e32 = ref["eps_min"][labels].astype(np.float32), eps.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        prob = np.where(labels > 0, np.where(e32 <= em, np.float32(1), em / e32), 0)
    return labels, prob.astype(np.float64)
