"""Consensus across sample draws (``models/consensus.py``) against the
reference: ``consensus_labels`` on the reference's hand-built cases, the
consensus MR fit end to end (labels, mean GLOSH, the representative
draw's tree, ``consensus_info``), the dispatch's device and type, and the
``<base>_consensus.json`` sidecar of ``write_outputs``."""

import json
import os

import jax
import numpy as np
import pytest

from hdbscan_tpu.config import HDBSCANParams as RefParams
from hdbscan_tpu.models import consensus as ref_consensus
from hdbscan_tpu.models import mr_hdbscan as ref_mr
from hdbscan_tpu.models.hdbscan import write_outputs as ref_write
from hdbscan_tpu_torch.config import HDBSCANParams as PortParams
from hdbscan_tpu_torch.models import consensus as port_consensus
from hdbscan_tpu_torch.models import mr_hdbscan as port_mr
from hdbscan_tpu_torch.models.hdbscan import write_outputs as port_write
from hdbscan_tpu_torch.ops import cuda_build
from tests.test_torch_mr import BASE, _assert_bitwise, _fit_both, _lattice
from tests.test_torch_mr_mesh import _one_thread  # noqa: F401


_SPLIT = np.array([1, 1, 1, 1, 2, 2, 2, 2])
_MERGED = np.ones(8, np.int64)


@pytest.mark.parametrize(
    "rows",
    [
        np.stack([np.array([0, 1, 1, 2, 2, 0])] * 5),
        np.stack([_SPLIT, _SPLIT, _SPLIT, _MERGED, _MERGED]),
        np.stack([_MERGED, _MERGED, _MERGED, _SPLIT, _SPLIT]),
        np.stack([_SPLIT[::2], _MERGED[:4], _SPLIT[::2], _MERGED[:4]]),
        np.stack([np.array([0, 0, 1, 1])] * 3 + [np.array([2, 0, 1, 1])] * 2),
        np.stack([np.array([1, 1, 2, 2, 3, 3]), np.array([7, 7, 5, 5, 9, 9])] * 2
                 + [np.array([1, 1, 2, 2, 3, 3])]),
        np.zeros((3, 5), np.int64),
    ],
    ids=["unanimous", "majority_split", "majority_merge", "even_tie", "noise_majority",
         "relabelled", "all_noise"],
)
def test_consensus_labels_match_reference(rows):
    got, cells = port_consensus.consensus_labels(rows, return_n_cells=True)
    want, want_cells = ref_consensus.consensus_labels(rows, return_n_cells=True)
    np.testing.assert_array_equal(got, want)
    assert cells == want_cells


def test_cell_explosion_guard():
    rows = np.random.default_rng(0).integers(1, 5000, size=(3, 20000))
    with pytest.raises(ValueError, match="distinct label tuples"):
        port_consensus.consensus_labels(rows)


def _check_consensus(port, ref):
    _assert_bitwise(port, ref)
    assert port.consensus_info == ref.consensus_info
    assert set(port.consensus_info) == {
        "draws", "cells", "clusters", "representative_draw", "representative_seed",
        "representative_agreement_ari", "labels", "outlier_scores", "tree_and_hierarchy"}


def test_consensus_fit_bitwise():
    """Three draws on the lattice: consensus labels, the across-draw mean
    GLOSH, the representative draw's tree, cores and levels, and the
    provenance dict equal the reference's; one ``consensus_draw`` event a
    draw."""
    port, ref, events = _fit_both(_lattice(), consensus_draws=3, seed=1)
    _check_consensus(port, ref)
    assert events.count("consensus_draw") == 3 and events.count("consensus") == 1


def test_consensus_fit_float32_bitwise():
    kw = {**BASE, "consensus_draws": 3, "variant": "rs"}
    with jax.enable_x64(False):
        ref = ref_mr.fit(_lattice(), RefParams(**kw))
    port = port_mr.fit(_lattice(), PortParams(**kw), device="cpu")
    _check_consensus(port, ref)


def test_draws_keep_the_callers_device_and_type(monkeypatch):
    """Every draw runs on the device and in the type the caller gave:
    ``resolve_device`` first sees the caller's argument and never None (no
    draw falls back to the default device), and a checkpoint_dir is
    ignored with the reference's warning."""
    seen = []
    real = cuda_build.resolve_device
    monkeypatch.setattr(cuda_build, "resolve_device", lambda d=None: seen.append(d) or real(d))
    dtypes = []
    real_rows = port_mr._fit_rows
    monkeypatch.setattr(port_mr, "_fit_rows",
                        lambda *a, **kw: dtypes.append((kw["device"], kw["dtype"]))
                        or real_rows(*a, **kw))
    params = PortParams(**{**BASE, "consensus_draws": 2, "processing_units": 400})
    with pytest.warns(UserWarning, match="checkpoint_dir is ignored"):
        port_mr.fit(_lattice()[:900], params, device="cpu", dtype=np.float64,
                    checkpoint_dir="unused")
    assert None not in seen and seen[0] == "cpu"
    assert [(str(d), t) for d, t in dtypes] == [("cpu", np.float64)] * 2
    with pytest.raises(ValueError, match="resolved device"):
        port_consensus.fit(_lattice(), params, device=None)


def test_write_outputs_consensus_sidecar(tmp_path):
    """The five files and the provenance sidecar, byte for byte with the
    reference's writer on the reference's result."""
    kw = {**BASE, "consensus_draws": 2, "seed": 2}
    ref = ref_mr.fit(_lattice(), RefParams(**kw))
    port = port_mr.fit(_lattice(), PortParams(**kw), device="cpu", dtype=np.float64)
    out = {}
    for tag, write, res, cls in (("ref", ref_write, ref, RefParams),
                                 ("port", port_write, port, PortParams)):
        paths = write(res, cls(**kw, out_dir=str(tmp_path / tag)))
        assert os.path.basename(paths["consensus_provenance"]) == "output_consensus.json"
        out[tag] = {k: open(p, "rb").read() for k, p in paths.items()}
    assert out["port"] == out["ref"]
    with open(tmp_path / "port" / "output_consensus.json") as f:
        assert json.load(f) == port.consensus_info
