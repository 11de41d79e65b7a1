"""Per-level checkpoint and resume of the MR-HDBSCAN* fit
(``utils/checkpoint.py``) against the reference's: the same file format,
data digest and parameter fingerprint, so a checkpoint written by either
package resumes in the other; a resumed fit equals the uninterrupted one
bitwise (labels, cores, scores, tree, level stats without ``wall_s`` and
the edge pool) and skips the global core pass."""

import json
import os

import numpy as np
import pytest

from hdbscan_tpu.config import HDBSCANParams as RefParams
from hdbscan_tpu.models import mr_hdbscan as ref_mr
from hdbscan_tpu.utils import checkpoint as ref_ckpt
from hdbscan_tpu_torch.config import HDBSCANParams as PortParams
from hdbscan_tpu_torch.models import mr_hdbscan as port_mr
from hdbscan_tpu_torch.utils import checkpoint as port_ckpt
from tests.test_torch_mr import BASE, _assert_bitwise, _lattice
from tests.test_torch_mr_mesh import _one_thread  # noqa: F401


def _port_fit(data, ckpt=None, max_levels=64, events=None, **overrides):
    trace = None if events is None else (lambda s, **f: events.append(s))
    return port_mr.fit(data, PortParams(**{**BASE, **overrides}), device="cpu",
                       dtype=np.float64, checkpoint_dir=ckpt, max_levels=max_levels,
                       keep_edge_pool=True, trace=trace)


def _ref_fit(data, ckpt=None, max_levels=64, **overrides):
    return ref_mr.fit(data, RefParams(**{**BASE, **overrides}), checkpoint_dir=ckpt,
                      max_levels=max_levels, keep_edge_pool=True)


def _assert_resumed(res, full):
    _assert_bitwise(res, full)
    for a, b in zip(res.edge_pool, full.edge_pool):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def uninterrupted():
    return _port_fit(_lattice())


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref"), ("port", "port")])
def test_interrupted_fit_resumes_to_the_uninterrupted_fit(tmp_path, uninterrupted, writer,
                                                          reader):
    """Stopped after level 1 (``max_levels=2`` raises), then resumed by
    either package from the files the other wrote."""
    x, ckpt = _lattice(), str(tmp_path)
    fit_w = _ref_fit if writer == "ref" else _port_fit
    with pytest.raises(RuntimeError, match="did not converge in 2 levels"):
        fit_w(x, ckpt, max_levels=2)
    assert sorted(os.listdir(ckpt)) == ["mr_level_0000.npz", "mr_level_0001.npz"]
    events = []
    if reader == "port":
        res = _port_fit(x, ckpt, events=events)
        assert events[0] == "resume_from_checkpoint" and "global_cores" not in events
    else:
        res = _ref_fit(x, ckpt)
    _assert_resumed(res, uninterrupted)


def test_boundary_resume_carries_margins_and_blocks(tmp_path):
    """Boundary mode: the seam margins and final blocks travel in the
    checkpoint."""
    x, ckpt = _lattice(), str(tmp_path)
    full = _port_fit(x, boundary_quality=0.1)
    with pytest.raises(RuntimeError):
        _ref_fit(x, ckpt, max_levels=3, boundary_quality=0.1)
    _assert_resumed(_port_fit(x, ckpt, boundary_quality=0.1), full)


def test_files_equal_the_reference_writer(tmp_path):
    """A level written by each package: the same members with the same
    contents (the level walls aside), the same digest and fingerprint."""
    x = _lattice()
    for tag, fit in (("ref", _ref_fit), ("port", _port_fit)):
        with pytest.raises(RuntimeError):
            fit(x, str(tmp_path / tag), max_levels=1)
    a = np.load(tmp_path / "ref" / "mr_level_0000.npz")
    b = np.load(tmp_path / "port" / "mr_level_0000.npz")
    assert a.files == b.files
    for name in a.files:
        if name != "meta":
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    meta = [json.loads(bytes(z["meta"]).decode()) for z in (a, b)]
    for m in meta:  # the level walls are the only host-clock field
        for st in m["level_stats"]:
            st.pop("wall_s")
    assert meta[0] == meta[1]
    assert port_ckpt._data_digest(x) == ref_ckpt._data_digest(x)
    params = dict(BASE, boundary_quality=0.2, variant="rs")
    assert (port_ckpt._fingerprint(PortParams(**params), 7, "d")
            == ref_ckpt._fingerprint(RefParams(**params), 7, "d"))


def test_fingerprint_mismatch_raises(tmp_path):
    x, ckpt = _lattice(), str(tmp_path)
    with pytest.raises(RuntimeError):
        _port_fit(x, ckpt, max_levels=1)
    with pytest.raises(ValueError, match="pass a fresh checkpoint_dir"):
        _port_fit(x, ckpt, min_cluster_size=21)
    assert port_ckpt.load_latest(str(tmp_path / "absent"), PortParams(**BASE), len(x)) is None
