"""Multi-process wiring and the mesh's hand-overs
(``hdbscan_tpu_torch/parallel/distributed.py``, ``parallel/mesh.py``)
against the reference's ``parallel/distributed.py``, on the CPU.

The slab arithmetic equals the reference's on its own cases; ``clusterName``
wiring keeps the reference's contract (``local`` and ``""`` do nothing, a
malformed spec raises ``ValueError`` naming ``clusterName``, a second call is
idempotent, a conflicting process count raises); the backend rule picks
NCCL only for distinct cards; the helpers are the identity, or a plain
concatenation, in one process. The library primitives over two real rank
processes (``global_rows_from_local`` then ``fetch``, the glue over a
two-rank mesh equal to the reference's single-controller glue) and a rank
that dies mid-run are here too; the command line over ranks is in
``tests/test_torch_multiprocess.py``.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from hdbscan_tpu.parallel import distributed as ref_distributed
from hdbscan_tpu_torch.parallel import distributed
from hdbscan_tpu_torch.parallel import mesh as mesh_mod
from tests.test_torch_mr_mesh import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_public_names_match_the_reference():
    assert sorted(distributed.__all__) == sorted(ref_distributed.__all__)
    for name in distributed.__all__:
        assert callable(getattr(distributed, name)), name


@pytest.mark.parametrize("n,count", [(10, 3), (1000, 8), (7, 8), (0, 4), (1000, 1)])
def test_host_row_slab_equals_reference(n, count):
    for i in range(count):
        assert distributed.host_row_slab(n, index=i, count=count) == \
            ref_distributed.host_row_slab(n, index=i, count=count)


def test_host_row_slab_live_defaults():
    assert distributed.host_row_slab(100) == (0, 100)  # not wired: one process


def test_local_is_noop():
    assert distributed.initialize_from_cluster_name("local") is False
    assert distributed.initialize_from_cluster_name("") is False
    assert not distributed.already_initialized()
    assert (distributed.process_count(), distributed.process_index()) == (1, 0)


@pytest.mark.parametrize("spec", ["not-a-spec-without-commas,x", "127.0.0.1:1,2,2",
                                  "127.0.0.1:1,0,0", ",0,1", "127.0.0.1:1,a,2"])
def test_malformed_spec_raises(spec):
    with pytest.raises(ValueError, match="clusterName"):
        distributed.initialize_from_cluster_name(spec)


def test_auto_without_torchrun_environment_raises(monkeypatch):
    for key in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        distributed.initialize_from_cluster_name("auto")


def test_wiring_is_idempotent_and_refuses_a_conflicting_count():
    """One rank wired in process: a second call with the same spec (or
    ``auto``) leaves it as it is, a call for two processes raises, and the
    mesh of a one-rank group is a one-process mesh."""
    port = distributed.free_local_port()
    spec = f"127.0.0.1:{port},0,1"
    try:
        assert distributed.initialize_from_cluster_name(spec, devices=["cpu"], timeout_s=30)
        assert distributed.initialize_from_cluster_name(spec, devices=["cpu"])
        assert distributed.initialize_from_cluster_name("auto")
        with pytest.raises(RuntimeError, match="conflicting wiring"):
            distributed.initialize_from_cluster_name(f"127.0.0.1:{port},0,2")
        assert distributed.backend() == "gloo"
        mesh = mesh_mod.get_mesh(["cpu", "cpu"])
        assert mesh.owners == (0, 0) and not mesh.multiprocess
        assert mesh.local_shards() == [0, 1]
    finally:
        distributed.shutdown()
    assert not distributed.already_initialized() and distributed.backend() is None


@pytest.mark.parametrize(
    "lists,backend",
    [
        ([["cpu"], ["cpu"]], "gloo"),
        ([["cpu", "cpu"], ["cpu", "cpu"]], "gloo"),
        ([["cuda:0"], ["cuda:0"]], "gloo"),  # two ranks sharing one card
        ([["cuda:0"], ["cuda:1"]], "nccl"),
        ([["cuda:0", "cuda:1"], ["cuda:2", "cuda:3"]], "gloo"),  # a rank over two cards
        ([["cuda:0", "cuda:0"], ["cuda:1"]], "nccl"),  # one rank's shards share its card
        ([["cuda:0"], ["cpu"]], "gloo"),
    ],
)
def test_backend_rule(lists, backend):
    assert distributed.choose_backend(lists) == backend


def test_hermetic_child_env(tmp_path, monkeypatch):
    hooked = tmp_path / "hooked"
    hooked.mkdir()
    (hooked / "sitecustomize.py").write_text("")
    plain = tmp_path / "plain"
    plain.mkdir()
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join([str(hooked), str(plain)]))
    monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    env = distributed.hermetic_child_env(REPO)
    assert env["PYTHONPATH"].split(os.pathsep) == [REPO, str(plain)]
    assert env["OMP_NUM_THREADS"] == "1"
    flags = ("JAX_", "XLA_")  # the port's ranks get no JAX flags of their own
    assert ({k: v for k, v in env.items() if k.startswith(flags)}
            == {k: v for k, v in os.environ.items() if k.startswith(flags)})
    assert "OMP_NUM_THREADS" not in distributed.hermetic_child_env(cpu=False)


def test_communicate_all_kills_the_set_on_timeout():
    procs = [subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
             for _ in range(2)]
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"rank\(s\) \[0, 1\]"):
        distributed.communicate_all(procs, timeout=1)
    assert time.monotonic() - t0 < 30
    assert all(p.poll() is not None for p in procs)


def test_one_process_helpers_are_plain():
    """Without ranks: ``fetch`` concatenates in shard order, ``fetch_many``
    skips shards that hold nothing, ``ring_shift`` hands each shard the
    panel ``(me - step) % D`` by ``Tensor.to``, ``all_reduce`` is the
    identity, no byte is counted, and ``global_rows_from_local`` splits the
    whole set over the shards."""
    mesh = mesh_mod.get_mesh(["cpu"] * 3)
    before = mesh_mod.comm_snapshot()[0]
    parts = {s: torch.arange(3 * s, 3 * s + s + 1) for s in range(3)}
    assert mesh_mod.fetch(parts, mesh).tolist() == [0, 3, 4, 6, 7, 8]
    got = mesh_mod.fetch_many({0: (torch.ones(2, 2),), 1: None, 2: (torch.zeros(1, 2),)}, mesh)
    assert got[0].tolist() == [[1, 1], [1, 1], [0, 0]]
    for step in range(3):
        out = mesh_mod.ring_shift(mesh, {s: (parts[s],) for s in range(3)}, step,
                                  [len(parts[s]) for s in range(3)])
        for me in range(3):
            assert torch.equal(out[me][0], parts[(me - step) % 3])
    t = torch.tensor([3.0, 1.0])
    assert mesh_mod.all_reduce(t, mesh) is t
    full = np.arange(20.0).reshape(10, 2)
    rows = distributed.global_rows_from_local(full, mesh, 10)
    assert sorted(rows) == [0, 1, 2] and [len(rows[s]) for s in range(3)] == [4, 4, 2]
    np.testing.assert_array_equal(mesh_mod.fetch(rows, mesh), full)
    with pytest.raises(ValueError, match="slabs"):
        distributed.global_rows_from_local(full, mesh, 11)
    assert mesh_mod.comm_snapshot()[0] == before


def test_one_process_ring_shift_takes_a_length_per_tensor():
    """A panel whose tensors differ in leading length (the sharded forest's
    rows, leaf members and thresholds): ``rows[s]`` as one length a tensor,
    each shard handed the panel ``(me - step) % D`` whole, nothing counted."""
    mesh = mesh_mod.get_mesh(["cpu"] * 3)
    before = mesh_mod.comm_snapshot()[0]
    panels = {s: (torch.full((5, 2), float(s)), torch.arange(3 * 4 * 2).reshape(3, 4, 2) + s,
                  torch.zeros((3, 0)))
              for s in range(3)}
    for step in range(3):
        out = mesh_mod.ring_shift(mesh, panels, step, [(5, 3, 3)] * 3)
        for me in range(3):
            src = (me - step) % 3
            assert len(out[me]) == 3
            for got, want in zip(out[me], panels[src]):
                assert got.shape == want.shape and torch.equal(got, want)
    assert mesh_mod.comm_snapshot()[0] == before


def test_no_card_and_no_cpu_flag_fails_before_wiring(tmp_path, capsys):
    """A rank with no card and no ``--device cpu`` fails at once (exit 1),
    without waiting for peers that will never come."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from hdbscan_tpu_torch.cli import main as port_main

    t0 = time.monotonic()
    assert port_main([f"file={tmp_path / 'absent.tsv'}", "clusterName=127.0.0.1:9,0,2"]) == 1
    assert time.monotonic() - t0 < 10
    assert "no CUDA device" in capsys.readouterr().err
    assert not distributed.already_initialized()


_LIBRARY_WORKER = """
import sys
import numpy as np
import torch
pid, nproc, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
from hdbscan_tpu_torch.parallel.distributed import (
    global_rows_from_local, host_row_slab, initialize_from_cluster_name)
spec = f"127.0.0.1:{port},{pid},{nproc}"
assert initialize_from_cluster_name(spec, devices=["cpu", "cpu"], timeout_s=60)
assert initialize_from_cluster_name(spec, devices=["cpu", "cpu"])  # idempotent
from hdbscan_tpu_torch.parallel.mesh import COMM, fetch, get_mesh
mesh = get_mesh(["cpu", "cpu"])
assert mesh.multiprocess and len(mesh.devices) == 4 and mesh.local_shards() == [2 * pid, 2 * pid + 1]
rng = np.random.default_rng(11)
full = rng.normal(size=(512, 4))
groups = np.arange(512) // 128
start, stop = host_row_slab(len(full))
rows = global_rows_from_local(full[start:stop], mesh, len(full))  # only this rank's slab
assert sorted(rows) == mesh.local_shards()
assert np.array_equal(fetch(rows, mesh), full)
from hdbscan_tpu_torch.ops.tiled import boruvka_glue_edges
res = {}
for data_name, x in (("normal", full), ("grid", np.round(full * 8))):
    for name, kw in (("host", {}), ("ring", {"scan_backend": "ring"}),
                     ("sharded", {"fit_sharding": "sharded"})):
        before = COMM["ring"]["bytes"]
        u, v, w = boruvka_glue_edges(x, groups, core=np.zeros(len(x)), mesh=mesh,
                                     device="cpu", **kw)
        key = f"{data_name}_{name}"
        res[f"{key}_u"], res[f"{key}_v"], res[f"{key}_w"] = u, v, w
        res[f"{key}_ring_bytes"] = np.array(COMM["ring"]["bytes"] - before)
np.savez(out, **res)
print("RANK_OK", pid)
"""


def test_library_slab_and_assembly_two_process(tmp_path):
    """The counterpart of the reference's two-process library test: each
    rank holds only its slab, ``fetch`` gives the full set back on both,
    and the glue over a two-rank, four-shard mesh (the host scanner, the
    ring and the sharded scanner) gives both ranks the same edges, equal
    to the port's one-process glue bitwise and to the reference's
    single-controller glue (sorted weights, as the reference's test holds
    them): bitwise on an integer grid of the same shape, to a float32 ulp
    on the reference test's own normal data, where XLA's CPU reduction
    order rounds one distance in four thousand otherwise. The ring and
    sharded scanners hand panels over between the ranks (bytes counted)."""
    from hdbscan_tpu.ops.tiled import boruvka_glue_edges as ref_glue
    from hdbscan_tpu_torch.ops.tiled import boruvka_glue_edges

    script = tmp_path / "worker.py"
    script.write_text(_LIBRARY_WORKER)
    port = distributed.free_local_port()
    outs = [tmp_path / f"rank{i}.npz" for i in range(2)]
    procs = [
        subprocess.Popen([sys.executable, str(script), str(pid), "2", str(port), str(outs[pid])],
                         env=distributed.hermetic_child_env(REPO), cwd=REPO,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in (0, 1)
    ]
    for p, (so, se) in zip(procs, distributed.communicate_all(procs, timeout=120)):
        assert p.returncode == 0, se[-3000:]
        assert "RANK_OK" in so
    a, b = np.load(outs[0]), np.load(outs[1])
    for key in a.files:
        if not key.endswith("_ring_bytes"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    rng = np.random.default_rng(11)
    full = rng.normal(size=(512, 4))
    groups = np.arange(512) // 128
    for data_name, x in (("normal", full), ("grid", np.round(full * 8))):
        one = boruvka_glue_edges(x, groups, core=np.zeros(len(x)), device="cpu")
        _, _, ref_w = ref_glue(x, groups, core=np.zeros(len(x)))
        for name in ("host", "ring", "sharded"):
            key = f"{data_name}_{name}"
            for got, want in zip((a[f"{key}_u"], a[f"{key}_v"], a[f"{key}_w"]), one):
                np.testing.assert_array_equal(got, want, err_msg=key)
            if data_name == "grid":
                np.testing.assert_array_equal(np.sort(a[f"{key}_w"]), np.sort(ref_w))
            else:
                np.testing.assert_allclose(np.sort(a[f"{key}_w"]), np.sort(ref_w),
                                           rtol=2 ** -23, atol=0)
            # The ring geometry pads a shard to the column tile, so one
            # rank's shards may be empty and send nothing; the pair moves.
            moved = int(a[f"{key}_ring_bytes"]) + int(b[f"{key}_ring_bytes"])
            assert moved == 0 if name == "host" else moved > 0, (key, moved)


_DEAD_WORKER = """
import os, sys, torch
pid, port = int(sys.argv[1]), sys.argv[2]
from hdbscan_tpu_torch.parallel.distributed import initialize_from_cluster_name
initialize_from_cluster_name(f"127.0.0.1:{port},{pid},2", devices=["cpu"], timeout_s=20)
from hdbscan_tpu_torch.parallel.mesh import all_reduce, get_mesh
mesh = get_mesh(["cpu"])
if pid == 1:
    os._exit(3)  # a rank lost mid-run, before its next collective
all_reduce(torch.zeros(4), mesh)
print("UNREACHABLE")
"""


def test_a_dead_rank_fails_its_peer_within_the_timeout(tmp_path):
    script = tmp_path / "dead.py"
    script.write_text(_DEAD_WORKER)
    port = distributed.free_local_port()
    procs = [subprocess.Popen([sys.executable, str(script), str(pid), str(port)],
                              env=distributed.hermetic_child_env(REPO), cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for pid in (0, 1)]
    t0 = time.monotonic()
    outs = distributed.communicate_all(procs, timeout=90)
    assert time.monotonic() - t0 < 60
    assert procs[1].returncode == 3
    assert procs[0].returncode != 0 and "UNREACHABLE" not in outs[0][0]
