"""Multi-process (multi-controller) runs — the port of
``parallel/distributed.py``.

The reference maps the Spark master flag ``clusterName=`` onto JAX's
multi-controller model: one process per host, ``jax.distributed`` joining
them into one device set. The port does the same over ``torch.distributed``:
every rank runs the same deterministic host loop on the same data and
seed, computes only the shards on its own devices, and every hand-over that
crosses a rank boundary is a collective (``parallel/mesh``: the ring panel
send/receive, the all-reduce and the all-gather of ``fetch``). Rank 0 alone
writes and prints.

- :func:`initialize_from_cluster_name` wires the process group
  (``local``: one process; ``auto``: torchrun's environment;
  ``<host:port>,<rank>,<ranks>``: explicit) and picks its backend by one
  rule (:func:`choose_backend`): NCCL when every rank's devices are one
  card and no card is named by two ranks, gloo otherwise. Ranks that share
  a card (each with its own CUDA context), and a rank over several cards,
  therefore hand over through gloo, staged through host memory. Nothing falls back: a failed NCCL init, a
  malformed spec or a conflicting wiring raises.
- :func:`host_row_slab` and :func:`global_rows_from_local`: each rank's
  contiguous row slab, placed on its own shards of the global mesh.
- :func:`hermetic_child_env`, :func:`free_local_port` and
  :func:`communicate_all`: the one copy of the rules for spawning ranks as
  OS processes (tests, ``chip_smoke.py``).

The reference's ``_backend_already_touched`` has no counterpart:
``torch.distributed`` is wired explicitly and a device touched before the
wiring changes nothing, so there is no silent no-op to detect.
"""

from __future__ import annotations

import os
import socket
from datetime import timedelta

import numpy as np

__all__ = [
    "already_initialized",
    "communicate_all",
    "free_local_port",
    "hermetic_child_env",
    "initialize_from_cluster_name",
    "host_row_slab",
    "global_rows_from_local",
    "process_count",
    "process_index",
]

#: Seconds a collective (and the wiring itself) may wait for a peer before
#: it raises: a dead rank fails its peers within this, it never hangs them.
TIMEOUT_S = 120.0

#: The wiring of this process: the backend, the process group every data
#: hand-over uses (None: the default, gloo, group) and each rank's device
#: identities, as :func:`initialize_from_cluster_name` decided them.
_WIRING: dict = {}


def _dist():
    import torch.distributed as dist

    return dist


def already_initialized() -> bool:
    """True when the process group is wired (``torch.distributed.
    is_initialized``)."""
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """The number of ranks (1 when the process is not wired)."""
    return _dist().get_world_size() if already_initialized() else 1


def process_index() -> int:
    """This process's rank (0 when the process is not wired)."""
    return _dist().get_rank() if already_initialized() else 0


def backend() -> str | None:
    """The backend the data hand-overs use (None when not wired)."""
    return _WIRING.get("backend") if already_initialized() else None


def data_group():
    """The process group of the data hand-overs (None: the default group)."""
    return _WIRING.get("group")



def choose_backend(rank_devices: list[list[str]]) -> str:
    """The backend rule: ``"nccl"`` when every rank's devices are one card
    (identities starting with ``cuda``; several shards on it allowed) and
    no card is named by two ranks, else ``"gloo"``. ``rank_devices[r]``
    lists rank r's device identities; two equal identities are one card.
    A rank over two or more cards takes gloo: the NCCL hand-overs stage on
    a rank's one card (``parallel/mesh``)."""
    owner: dict[str, int] = {}
    for r, devs in enumerate(rank_devices):
        if len(set(map(str, devs))) != 1:
            return "gloo"
        for d in devs:
            if not str(d).startswith("cuda"):
                return "gloo"
            if owner.setdefault(str(d), r) != r:
                return "gloo"
    return "nccl"


def device_identity(device) -> str:
    """A device's identity across ranks: ``cpu@host``, or for a card
    ``cuda:<uuid>@host`` (the card's UUID, so two ranks naming one card
    under different indices still see one card)."""
    import torch

    dev = torch.device(device)
    host = socket.gethostname()
    if dev.type != "cuda":
        return f"{dev.type}@{host}"
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    uuid = getattr(torch.cuda.get_device_properties(idx), "uuid", None)
    return f"cuda:{uuid if uuid is not None else idx}@{host}"


def _kind(device) -> str:
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    return torch.cuda.get_device_name(dev.index if dev.index is not None else None)


def _local_devices(devices):
    import torch

    if devices is not None:
        return [torch.device(d) for d in devices]
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def initialize_from_cluster_name(cluster_name: str, devices=None,
                                 timeout_s: float = TIMEOUT_S) -> bool:
    """Wire this process into a multi-process run per ``clusterName=``.

    - ``"local"`` or ``""`` (the reference default): nothing; returns False.
    - ``"auto"``: torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``,
      ``RANK``, ``WORLD_SIZE``; ``LOCAL_RANK`` is torchrun's own).
    - ``"<host:port>,<rank>,<ranks>"``: ``init_process_group`` at
      ``tcp://host:port``.

    ``devices`` are this rank's devices (default: every visible card, else
    the CPU); the ranks exchange their identities (:func:`device_identity`)
    over the gloo group the wiring first makes, and :func:`choose_backend`
    picks the data group's backend from them (an NCCL group is made on
    top; its failure raises). ``timeout_s`` bounds the wiring and every
    collective after it. Returns True when wired, also when it already was
    (idempotent); raises ValueError naming ``clusterName`` on a malformed
    spec and RuntimeError when already wired with another process count.
    """
    if cluster_name in ("", "local"):
        return False
    nproc = pid = coordinator = None
    if cluster_name != "auto":
        try:
            coordinator, pid, nproc = cluster_name.rsplit(",", 2)
            pid, nproc = int(pid), int(nproc)
            if not coordinator or nproc < 1 or not 0 <= pid < nproc:
                raise ValueError(cluster_name)
        except ValueError as e:
            raise ValueError(
                f"clusterName must be 'local', 'auto', or "
                f"'<host:port>,<process_id>,<num_processes>'; got {cluster_name!r}"
            ) from e
    dist = _dist()
    if already_initialized():
        if nproc is not None and dist.get_world_size() != nproc:
            raise RuntimeError(
                f"torch.distributed was already initialized with "
                f"{dist.get_world_size()} processes, but clusterName="
                f"{cluster_name!r} requests {nproc} — conflicting wiring"
            )
        return True
    timeout = timedelta(seconds=timeout_s)
    if cluster_name == "auto":
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
                   if k not in os.environ]
        if missing:
            raise RuntimeError(f"clusterName=auto needs torchrun's environment; "
                               f"missing {missing}")
        dist.init_process_group("gloo", init_method="env://", timeout=timeout)
    else:
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator}", rank=pid,
                                world_size=nproc, timeout=timeout)
    mine = [(device_identity(d), _kind(d)) for d in _local_devices(devices)]
    lists: list = [None] * dist.get_world_size()
    dist.all_gather_object(lists, mine)
    chosen = choose_backend([[ident for ident, _ in lst] for lst in lists])
    group = None
    if chosen == "nccl":
        import torch

        card = _local_devices(devices)[0]  # the rule gives each rank one card
        torch.cuda.set_device(card)
        group = dist.new_group(backend="nccl", timeout=timeout)
        # One collective over every rank first, so the communicator exists
        # before any batched send/receive pair (which need not involve all).
        dist.all_reduce(torch.zeros(1, device=card), group=group)
    _WIRING.clear()
    _WIRING.update(backend=chosen, group=group, devices=lists)
    return True


def rank_devices() -> list[list[tuple[str, str]]]:
    """Every rank's devices as the wiring exchanged them: per rank, a list
    of (identity, kind) pairs ([] when not wired)."""
    return list(_WIRING.get("devices", [])) if already_initialized() else []


def shutdown() -> None:
    """Tear the process group down (a rank that raised calls this so its
    peers fail at their next collective instead of waiting)."""
    if already_initialized():
        _dist().destroy_process_group()
    _WIRING.clear()


def hermetic_child_env(repo_root: str | None = None, *, cpu: bool = True) -> dict:
    """The environment for spawning a rank as an OS process: ``repo_root``
    first on ``PYTHONPATH``, every entry that carries a
    ``sitecustomize.py`` dropped (an interpreter-start hook must not touch
    devices or threads before the rank wires itself), and for CPU ranks
    ``OMP_NUM_THREADS=1``, so ranks sharing a machine do not oversubscribe
    its cores. One copy of these rules; callers do not re-implement them."""
    env = dict(os.environ)
    keep = [
        p
        for p in env.get("PYTHONPATH", "").split(os.pathsep)
        if p and not os.path.isfile(os.path.join(p, "sitecustomize.py"))
    ]
    env["PYTHONPATH"] = os.pathsep.join(([repo_root] if repo_root else []) + keep)
    if cpu:
        env["OMP_NUM_THREADS"] = "1"
    return env


def free_local_port(attempts: int = 5, backoff_s: float = 0.05) -> int:
    """An OS-assigned free TCP port for a local coordinator.

    Retries with exponential backoff: under parallel test runs the
    ephemeral range can be transiently exhausted, and one losing bind
    should not fail a whole multi-rank test. The port is released before
    the coordinator binds it — callers pair this with
    :func:`communicate_all`'s kill-the-set timeout so a lost race cannot
    leak ranks blocked on a dead port.
    """
    import time

    last_err = None
    for attempt in range(attempts):
        try:
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                return s.getsockname()[1]
        except OSError as e:  # pragma: no cover - needs ephemeral exhaustion
            last_err = e
            time.sleep(backoff_s * (2**attempt))
    raise OSError(
        f"free_local_port: no ephemeral port after {attempts} attempts"
    ) from last_err  # pragma: no cover


def communicate_all(procs, timeout: int = 300):
    """``communicate()`` every subprocess; kill the whole set on any timeout.

    A hung rank must not leak its peers blocked at a collective holding the
    port. Returns [(stdout, stderr)] in order. On timeout the whole set is
    killed and a ``TimeoutError`` names the ranks still running when the
    deadline hit; the original ``subprocess.TimeoutExpired`` rides as
    ``__cause__``.
    """
    import subprocess

    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    except subprocess.TimeoutExpired as e:
        dead = [i for i, p in enumerate(procs) if p.poll() is None]
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.communicate()
        raise TimeoutError(
            f"communicate_all: rank(s) {dead} of {len(procs)} still running "
            f"after {timeout}s — killed the whole set (coordinator-port race "
            "or a rank lost mid-collective leaves peers blocked at a "
            "barrier)"
        ) from e
    return outs


def host_row_slab(n_rows: int, index: int | None = None, count: int | None = None):
    """This rank's contiguous row range [start, stop) of an n-row dataset:
    balanced to within one row (the first ``n % count`` ranks get the
    extra), covering every row exactly once across ranks."""
    index = process_index() if index is None else index
    count = process_count() if count is None else count
    base, extra = divmod(n_rows, count)
    start = index * base + min(index, extra)
    stop = start + base + (1 if index < extra else 0)
    return start, stop


def global_rows_from_local(local_rows: np.ndarray, mesh, n_global: int) -> dict:
    """This rank's row slab placed on its own shards of ``mesh``: the slab
    splits over the rank's shards as ``mesh.block_shards`` splits a batch,
    and the result is ``{shard: tensor on its device}`` for this rank's
    shards, so ``parallel/mesh.fetch(result, mesh)`` reassembles the full
    (``n_global``, ...) set in row order on every rank. Raises when the
    ranks' slabs do not add up to ``n_global``. With one process it is the
    whole set split over the mesh."""
    import torch

    from hdbscan_tpu_torch.parallel.mesh import all_reduce, block_shards

    local_rows = np.ascontiguousarray(local_rows)
    total = all_reduce(torch.tensor([len(local_rows)], dtype=torch.int64), mesh, op="sum")
    if int(total[0]) != n_global:
        raise ValueError(f"the ranks' slabs hold {int(total[0])} rows, not {n_global}")
    local = mesh.local_shards()
    out = {}
    for s, (a, b, dev) in zip(local, block_shards([mesh.devices[s] for s in local],
                                                  len(local_rows))):
        out[s] = torch.as_tensor(local_rows[a:b], device=dev)
    return out
