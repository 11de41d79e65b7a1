"""The numbers that decide ``correct``, each compared with its limit.

Fit cells (``reference.judge_fit``): ``core_gap``, the widest relative gap
of a row's core distance from the reference's; ``mst_gap``, the widest
relative gap of a tree edge's weight from the reference's weight of that
edge; ``mst_excess``, how far the tree is from minimum over all pairs;
``label_rows``, the rows whose cluster differs once the program's clusters
are matched one to one with the reference's (noise with noise). Serving
cells: ``label_rows`` over the sampled query rows, through the matching of
the served fit's training labels, ``prob_gap``, the widest gap of a
membership probability, and the served fit's ``fit_label_rows`` and
``fit_mst_excess``.
"""

from __future__ import annotations

import numpy as np


def rel_gap(a, b) -> float:
    """Widest |a - b| / |b| (0 where both are 0); inf on a shape mismatch
    or a value that is not finite where the other is."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    if not a.size:
        return 0.0
    diff = np.abs(a - b)
    diff[np.isinf(a) & np.isinf(b) & (np.sign(a) == np.sign(b))] = 0.0
    with np.errstate(divide="ignore", invalid="ignore"):
        g = np.where(diff == 0, 0.0, diff / np.abs(b))
    g[np.isnan(g)] = np.inf
    return float(g.max())


def matching(prog: np.ndarray, ref: np.ndarray) -> dict:
    """One-to-one map of program cluster labels to reference labels, greedy
    by overlap (largest first); noise (0) maps to noise only."""
    prog, ref = np.asarray(prog, np.int64), np.asarray(ref, np.int64)
    pairs, counts = np.unique(np.stack([prog, ref]), axis=1, return_counts=True)
    mapping, used = {0: 0}, {0}
    for k in np.argsort(-counts, kind="stable"):
        p, r = int(pairs[0, k]), int(pairs[1, k])
        if p in mapping or r in used or p == 0 or r == 0:
            continue
        mapping[p] = r
        used.add(r)
    return mapping


def label_rows(prog, ref, mapping: dict | None = None) -> int:
    """Rows whose program label, mapped, differs from the reference's."""
    prog, ref = np.asarray(prog, np.int64), np.asarray(ref, np.int64)
    if prog.shape != ref.shape:
        return max(len(prog), len(ref))
    mapping = matching(prog, ref) if mapping is None else mapping
    mapped = np.array([mapping.get(int(p), -1) for p in prog], np.int64) if len(prog) \
        else prog
    return int(np.sum(mapped != ref))


def predict_numbers(prog_labels, prog_prob, ref_labels, ref_prob, mapping: dict) -> dict:
    """The serving cells' numbers over the sampled query rows."""
    prob = np.abs(np.asarray(prog_prob, np.float64) - np.asarray(ref_prob, np.float64))
    return {"label_rows": label_rows(prog_labels, ref_labels, mapping),
            "prob_gap": float(prob.max()) if prob.size else 0.0}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}}). A
    number with no limit fails, and so does a limit with no number."""
    out, ok = {}, set(numbers) == set(limits)
    for name in sorted(set(numbers) | set(limits)):
        value, limit = numbers.get(name), limits.get(name)
        out[name] = {"value": value, "limit": limit}
        if value is None or limit is None or not value <= limit:
            ok = False
    return ok, out
