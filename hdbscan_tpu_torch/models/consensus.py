"""Consensus clustering across sample draws — the seed-variance closer; the
port of the reference package's ``models/consensus.py`` (host numpy and
``scipy.cluster.hierarchy``; every draw is a ``models/mr_hdbscan`` fit on
the caller's device and type).

The bubble pipeline's flat cut on lattice-valued data is BIMODAL across
sample draws: Skin's integer-lattice distance ties admit two readings of the
same region, and the sample draw picks which one the bubble tree resolves to
(std 0.034 against the paper's 0.002 at the 45-run protocol,
ResearchReport.pdf §5.2). More refinement measurably does
NOT help (the spread is structural); averaging over draws does.

This module implements evidence-accumulation consensus (co-association of
several cheap models) on the LABEL-TUPLE QUOTIENT space, so it never builds
an n x n co-association matrix:

1. Run ``n_draws`` full pipelines with distinct seeds (each ~seconds at the
   north-star scale — the draws, not the consensus, dominate cost).
2. Compress points to CELLS: the distinct columns of the (B, n) label
   matrix. Every point in a cell received identical labels in every draw,
   so any co-association-based partition is constant on cells. B small
   cluster counts keep the cell count C tiny (tens) where n is 245k.
3. Cell co-association = fraction of draws assigning both cells the same
   non-noise cluster; average-linkage agglomeration on (1 - agreement),
   cut at 0.5 = "a majority of draws agree these regions are one cluster".
4. Cells whose majority reading is noise stay noise; the rest take their
   merged group as the consensus flat label.

The returned result is the REPRESENTATIVE draw (max ARI agreement with the
consensus partition) with its labels replaced by the consensus and its
outlier scores replaced by the ACROSS-DRAW MEAN of the draws' GLOSH scores
— a statistic of the same ensemble the labels come from, so the partition
and the scores describe the same stabilized reading. The tree and core distances still describe the representative
draw; ``result.consensus_info`` records that provenance and the output
writer emits it as a sidecar file. The Java code has nothing comparable:
its §5.2 protocol reruns 45 times and reports the spread.
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: Cell-count guard: the (C, C, B) agreement broadcast is the only dense
#: temporary; past this, the label structure is too fragmented for
#: quotient-space consensus to be meaningful (and the draws themselves are
#: likely noise-dominated).
_MAX_CELLS = 4096


def consensus_labels(
    label_rows: np.ndarray, return_n_cells: bool = False
):
    """(B, n) per-draw flat labels (0 = noise) -> (n,) consensus labels.

    Majority semantics: two points share a consensus cluster when the
    average-linkage agreement of their cells is > 0.5 across draws; a point
    is consensus-noise when >= half its draws called it noise.
    ``return_n_cells``: also return the cell count (already computed here —
    callers must not redo the O(n·B log n) unique for a trace field).
    """
    label_rows = np.asarray(label_rows)
    b, n = label_rows.shape
    cells, cell_of = np.unique(label_rows.T, axis=0, return_inverse=True)
    c = len(cells)
    if c > _MAX_CELLS:
        raise ValueError(
            f"{c} distinct label tuples across {b} draws (max {_MAX_CELLS}): "
            "the draws disagree too finely for quotient-space consensus"
        )
    noise_major = (cells == 0).mean(axis=1) >= 0.5
    keep = np.nonzero(~noise_major)[0]
    out = np.zeros(n, np.int64)
    if len(keep) == 0:
        return (out, c) if return_n_cells else out
    if len(keep) == 1:
        grp = np.array([1])
    else:
        # agreement[a, b] = fraction of draws where both cells carry the
        # same NON-NOISE label (noise never co-associates: the ARI protocol
        # treats noise points as singletons, ResearchReport.pdf §5.2).
        # Accumulated one draw at a time: a (C, C, B) broadcast would
        # transiently hold ~C²·B bools (~755 MB at the guard ceiling with a
        # 45-draw protocol); per-draw accumulation keeps the peak at one
        # (C, C) float regardless of B.
        sub = cells[keep]
        agree = np.zeros((len(keep), len(keep)))
        for d_i in range(b):
            col = sub[:, d_i]
            agree += (col[:, None] == col[None, :]) & (col[:, None] > 0)
        agree /= b
        from scipy.cluster.hierarchy import fcluster, linkage
        from scipy.spatial.distance import squareform

        dis = 1.0 - agree
        np.fill_diagonal(dis, 0.0)
        z = linkage(squareform(dis, checks=False), method="average")
        # Cut strictly below 0.5 dissimilarity = majority agreement. fcluster
        # keeps merges with cophenetic distance <= t; use t just under 0.5 so
        # exact 50/50 ties (an even draw count split clean) stay SPLIT —
        # merging on a non-majority would let one draw's reading dominate.
        grp = fcluster(z, t=0.5 - 1e-9, criterion="distance")
    cell_label = np.zeros(c, np.int64)
    cell_label[keep] = grp
    lab = cell_label[cell_of]
    return (lab, c) if return_n_cells else lab


def fit(
    data: np.ndarray,
    params,
    *,
    device,
    dtype=np.float32,
    max_levels: int = 64,
    trace=None,
    keep_edge_pool: bool = False,
):
    """Run ``params.consensus_draws`` pipelines and return the consensus.

    Draw i uses seed ``params.seed * n_draws + i`` — disjoint seed blocks
    across sweep seeds, so a 45-seed stability protocol over consensus runs
    never reuses a draw. Every draw runs on ``device`` in ``dtype`` (the
    caller's; ``mr_hdbscan.fit`` resolves the device once before it
    dispatches here). Checkpointing is per-draw-disabled (a consensus run
    is cheap multiples of a cheap run; re-running a lost draw is simpler
    than resuming five).
    """
    from hdbscan_tpu_torch.models import mr_hdbscan
    from hdbscan_tpu_torch.utils.evaluation import adjusted_rand_index

    if device is None:
        raise ValueError("consensus.fit needs the resolved device of its caller")
    b = params.consensus_draws
    if b < 2:
        raise ValueError("consensus fit needs consensus_draws >= 2")
    results = []
    for i in range(b):
        p = params.replace(consensus_draws=1, seed=params.seed * b + i)
        results.append(
            mr_hdbscan.fit(
                data, p, device=device, dtype=dtype, max_levels=max_levels, trace=trace,
                keep_edge_pool=keep_edge_pool,
            )
        )
        if trace is not None:
            trace("consensus_draw", draw=i, seed=p.seed)
    labs = np.stack([r.labels for r in results])
    cons, n_cells = consensus_labels(labs, return_n_cells=True)
    agr = [
        adjusted_rand_index(r.labels, cons, noise_as_singletons=True)
        for r in results
    ]
    best = int(np.argmax(agr))
    # Consensus outlier scores: the across-draw mean GLOSH — the ensemble
    # statistic matching the consensus labels (see module docstring).
    mean_scores = np.mean([r.outlier_scores for r in results], axis=0)
    info = {
        "draws": b,
        "cells": int(n_cells),
        "clusters": int(cons.max()),
        "representative_draw": best,
        "representative_seed": int(params.seed * b + best),
        "representative_agreement_ari": round(float(agr[best]), 4),
        "labels": "consensus partition over all draws",
        "outlier_scores": "mean GLOSH over all draws",
        "tree_and_hierarchy": "representative draw only",
    }
    if trace is not None:
        trace(
            "consensus",
            draws=b,
            cells=n_cells,
            clusters=int(cons.max()),
            representative=best,
            agreement=round(float(agr[best]), 4),
        )
    return dataclasses.replace(
        results[best],
        labels=cons,
        outlier_scores=mean_scores,
        consensus_info=info,
    )
