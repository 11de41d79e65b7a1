"""The device mesh of the sharded programs — the port of
``parallel/mesh.py``.

The reference drives a 1-D ``jax.sharding.Mesh`` through ``shard_map``,
from one controller or, wired by ``jax.distributed``, from one controller a
host. The port keeps that shape without a JAX mesh: a :class:`Mesh` is the
ordered global list of shards, shard ``s`` of every sharded array living on
``devices[s]`` in the process of rank ``owners[s]``. A list may name one
device several times — several shards on one card, the analog of the
reference's forced multi-device CPU mesh — and on a machine with several
cards it names each card once. There is no ``NamedSharding``: a shard's
tensors simply lie on its device, in its owner's process.

One process owns every shard unless the process group is wired
(``parallel/distributed``); then :func:`get_mesh` all-gathers every rank's
device list into one global mesh, as ``jax.devices()`` is global in the
reference, and each rank launches only its own shards' kernels
(:meth:`Mesh.local_shards`). What crosses a rank boundary goes through the
three helpers below, and nothing else does: :func:`ring_shift` (the panel
send/receive of one ring step, the analog of ``ppermute``),
:func:`all_reduce` (elementwise ``MIN``, or ``SUM`` for counts) and
:func:`fetch` (the all-gather of per-shard tensors, the analog of
``process_allgather(tiled=True)``). Under gloo a card's tensor is copied to
the host, exchanged and copied back to the rank's device, explicitly; under
NCCL (one card a rank) it is exchanged on that card. Every helper adds what
it handed over to :data:`COMM` (bytes, calls, wall), which the ring traces
read.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

#: Per helper: the payload bytes this rank handed to its collectives (a
#: ring step's sent panels, an all-reduce's buffer, an all-gather's padded
#: contribution), their calls and their wall (s). Only cross-rank traffic
#: counts; a one-process mesh adds nothing.
COMM = {k: {"bytes": 0, "calls": 0, "wall_s": 0.0} for k in ("ring", "all_reduce", "gather")}


def comm_snapshot() -> tuple[int, float]:
    """(bytes, wall s) summed over the helpers so far: subtract two
    snapshots for what a span of work handed over."""
    return (sum(v["bytes"] for v in COMM.values()),
            sum(v["wall_s"] for v in COMM.values()))


def _count(kind: str, nbytes: int, t0: float) -> None:
    COMM[kind]["bytes"] += int(nbytes)
    COMM[kind]["calls"] += 1
    COMM[kind]["wall_s"] += time.monotonic() - t0


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: shard ``s`` lives on ``devices[s]``, in the process of
    rank ``owners[s]`` (default: this process owns every shard).
    ``cards`` holds each shard's device identity across ranks (two shards
    with one identity share a device); ``backend`` and ``group`` are the
    data hand-overs' (``parallel/distributed``)."""

    devices: tuple
    owners: tuple | None = None
    rank: int = 0
    cards: tuple | None = None
    backend: str | None = None
    group: object = field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.owners is None:
            object.__setattr__(self, "owners", (self.rank,) * len(self.devices))
        if self.cards is None:
            object.__setattr__(self, "cards", tuple([str(d) for d in self.devices]))

    @property
    def multiprocess(self) -> bool:
        """True when two or more ranks own shards of the mesh."""
        return len(set(self.owners)) > 1

    @property
    def processes(self) -> int:
        return len(set(self.owners))

    def local_shards(self) -> list[int]:
        """This rank's shards, in shard order."""
        return [s for s, o in enumerate(self.owners) if o == self.rank]

    def is_local(self, s: int) -> bool:
        return self.owners[s] == self.rank

    @property
    def root(self) -> torch.device:
        """This rank's first shard's device: where its cross-shard
        reductions and its whole-set buffers land."""
        return self.devices[self.local_shards()[0]]

    def distinct(self) -> list:
        """This rank's devices without repeats, in shard order."""
        return list(dict.fromkeys(self.devices[s] for s in self.local_shards()))


def get_mesh(devices: list | None = None) -> Mesh:
    """1-D mesh over ``devices`` (default: every visible card, one shard
    each). Raises when no device is given and no card is present, and on a
    mesh that mixes the CPU and cards: a mesh's shards all take the kernels
    or all their plain versions, as a JAX mesh is of one platform.

    In a wired process (``parallel/distributed``) ``devices`` are this
    rank's, and every rank's lists are all-gathered, in rank order, into
    one global mesh whose shard count is their sum."""
    from hdbscan_tpu_torch.parallel import distributed

    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: pass get_mesh([torch.device('cpu')] * D) "
                "to shard on the CPU"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple([torch.device(d) for d in devices])
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if not distributed.already_initialized():
        _check_platform(devices)
        return Mesh(devices)
    import torch.distributed as dist

    mine = [(str(d), distributed.device_identity(d)) for d in devices]
    lists: list = [None] * dist.get_world_size()
    dist.all_gather_object(lists, mine)
    flat = [(torch.device(d), ident, r) for r, lst in enumerate(lists) for d, ident in lst]
    _check_platform([d for d, _, _ in flat])
    return Mesh(tuple([d for d, _, _ in flat]), owners=tuple([r for _, _, r in flat]),
                rank=dist.get_rank(), cards=tuple([i for _, i, _ in flat]),
                backend=distributed.backend(), group=distributed.data_group())


def _check_platform(devices) -> None:
    if len({d.type for d in devices}) > 1:
        raise ValueError(f"a mesh's devices must be all CPU or all CUDA, got "
                         f"{[str(d) for d in devices]}")


def spans_cards(mesh: Mesh | None) -> bool:
    """A mesh of two or more distinct CUDA devices (by identity, across
    ranks): where ``auto`` takes the sharded and ring engines (the
    reference's multi-device TPU rule). Every rank decides it alike."""
    if mesh is None:
        return False
    return (len(set(mesh.cards)) > 1
            and all(d.type == "cuda" for d in mesh.devices))


def device_count(mesh: Mesh) -> int:
    """Number of shards on the (1-D, global) mesh."""
    return len(mesh.devices)


def ring_permutation(n_dev: int) -> list[tuple[int, int]]:
    """Pairs of one unidirectional ring rotation step: shard i hands its
    held panel to i + 1 (mod n_dev), so after s steps shard i holds the
    panel that originated at (i - s) mod n_dev. The ring scans
    (``parallel/ring.py``) take exactly n_dev - 1 such steps per sweep."""
    return [(i, (i + 1) % n_dev) for i in range(n_dev)]


def pad_batch(batch_size: int, num_devices: int) -> int:
    """A batch axis padded up to a multiple of the shard count (the
    reference's ``pad_batch``)."""
    return -(-batch_size // num_devices) * num_devices


def block_shards(devices, batch: int) -> list[tuple[int, int, torch.device]]:
    """The reference's ``block_sharding`` of a (batch, ...) stack over the
    shards ``devices`` (a mesh's ``devices``): the batch axis padded to a
    multiple of the shard count (:func:`pad_batch`) and cut into equal
    contiguous slices, shard ``s``'s on ``devices[s]``. Returns each
    shard's ``(start, stop, device)`` over the REAL entries, clipped to
    ``batch``; a shard whose slice is all padding gets ``start == stop``
    and runs nothing."""
    per = pad_batch(batch, len(devices)) // len(devices)
    return [(min(s * per, batch), min((s + 1) * per, batch), dev)
            for s, dev in enumerate(devices)]


# --------------------------------------------------------------------------
# The hand-overs between ranks
# --------------------------------------------------------------------------


def _wire(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` as the data group carries it: under gloo a contiguous host copy,
    under NCCL a copy on this rank's one card (``mesh.root``); a fresh copy
    either way, so in-place collectives never write the caller's tensor;
    bool as uint8."""
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    return t.detach().to(_wire_device(mesh), copy=True).contiguous()


def _wire_device(mesh: Mesh) -> torch.device:
    """Where the data group's buffers lie: this rank's card under NCCL (one
    card a rank, ``parallel/distributed.choose_backend``), else the host."""
    return mesh.root if mesh.backend == "nccl" else torch.device("cpu")


def _unwire(t: torch.Tensor, dtype, device) -> torch.Tensor:
    return t.to(device).to(dtype) if dtype == torch.bool else t.to(device)


def all_reduce(t: torch.Tensor, mesh: Mesh | None, op: str = "min") -> torch.Tensor:
    """Elementwise ``min`` (or ``sum``) of ``t`` across the ranks of a
    multi-process mesh, back on ``t``'s device; ``t`` itself elsewhere.
    MIN is exact and order-free, so a key reduced per rank and then here
    equals the one-process reduction bitwise."""
    if mesh is None or not mesh.multiprocess:
        return t
    import torch.distributed as dist

    t0 = time.monotonic()
    buf = _wire(t, mesh)
    ops = {"min": dist.ReduceOp.MIN, "sum": dist.ReduceOp.SUM}
    dist.all_reduce(buf, op=ops[op], group=mesh.group)
    out = _unwire(buf, t.dtype, t.device)
    _count("all_reduce", buf.numel() * buf.element_size(), t0)
    return out


def ring_shift(mesh: Mesh, panels: dict, step: int, rows) -> dict:
    """One ring step of panel hand-overs: ``panels`` maps every local shard
    to its tuple of tensors; returns, for every local shard ``me``, the
    tuple of shard ``(me - step) % D`` on ``me``'s device. ``rows[s]`` is
    shard ``s``'s leading length, shared by every tensor of its panel, or a
    tuple of one leading length a tensor (the trailing shapes and types are
    the local panels'), so a receiver sizes its buffers without asking. A
    panel of a local shard moves with ``Tensor.to`` (nothing moves on a
    shared card); one of another rank's shard arrives by a send/receive
    pair a non-empty tensor, every pair of the step batched together.
    Every rank takes every step, so the pairs always match."""
    n_dev = len(mesh.devices)
    # Tuples here are built from lists: the CPU memory auditor's sampler
    # thread walks ``gc.get_objects()``, and a tuple a generator is still
    # filling must not be handed to it.
    out, recv = {}, []
    for me in panels:
        src = (me - step) % n_dev
        if mesh.is_local(src):
            out[me] = tuple([t.to(mesh.devices[me]) for t in panels[src]])
        else:
            recv.append((me, src))
    send = [(src, (src + step) % n_dev) for src in panels
            if not mesh.is_local((src + step) % n_dev)]
    if not send and not recv:
        return out
    import torch.distributed as dist

    t0 = time.monotonic()
    like = next(iter(panels.values()))
    n_t = len(like)

    def lengths(s):
        return rows[s] if isinstance(rows[s], tuple) else (rows[s],) * n_t

    ops, sent, bufs = [], 0, {}
    for src, dst in send:
        for i, (t, m) in enumerate(zip(panels[src], lengths(src))):
            if not m:  # an empty tensor travels as its receiver's empty buffer
                continue
            w = _wire(t, mesh)
            sent += w.numel() * w.element_size()
            ops.append(dist.P2POp(dist.isend, w, mesh.owners[dst], group=mesh.group,
                                  tag=src * n_t + i))
    for me, src in recv:
        bufs[me] = []
        for i, (t, m) in enumerate(zip(like, lengths(src))):
            dtype = torch.uint8 if t.dtype == torch.bool else t.dtype
            b = torch.empty((m, *t.shape[1:]), dtype=dtype, device=_wire_device(mesh))
            bufs[me].append(b)
            if m:
                ops.append(dist.P2POp(dist.irecv, b, mesh.owners[src], group=mesh.group,
                                      tag=src * n_t + i))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    for me, _ in recv:
        out[me] = tuple([_unwire(b, t.dtype, mesh.devices[me])
                         for b, t in zip(bufs[me], like)])
    _count("ring", sent, t0)
    return out


def fetch(shards, mesh: Mesh | None = None) -> np.ndarray:
    """Per-shard tensors concatenated on the host, in shard order.

    ``shards`` is a list in shard order, or a dict ``{shard: tensor}``
    over this rank's shards; over a multi-process mesh every rank's dict
    is all-gathered (:func:`fetch_many`), so every rank returns the same
    whole array."""
    if isinstance(shards, dict):
        return fetch_many({s: (t,) for s, t in shards.items()}, mesh)[0]
    return np.concatenate([t.cpu().numpy() for t in shards])


#: The trailing dimensions :func:`fetch_many`'s metadata can carry.
_MAX_DIMS = 4
#: The element types :func:`fetch_many` carries, by their code in its
#: metadata.
_TYPES = (torch.float32, torch.float64, torch.int32, torch.int64, torch.uint8, torch.bool,
          torch.int16, torch.int8, torch.float16, torch.bfloat16)


def fetch_many(parts: dict, mesh: Mesh | None) -> tuple:
    """:func:`fetch` of several arrays at once: ``parts`` maps every local
    shard to a tuple of tensors, or to None where the shard holds none (the
    i-th of each shard shares its trailing shape and type; leading lengths
    may differ, zero included). Returns one numpy array per position,
    concatenated in shard order across every rank: one all-reduce of the
    lengths, types and trailing shapes (so a rank whose shards hold nothing
    still joins), then one all-gather a position, each rank's contribution
    padded to the largest and cut back."""
    order = [s for s in sorted(parts) if parts[s] is not None]
    if mesh is None or not mesh.multiprocess:
        n_t = len(parts[order[0]])
        return tuple([np.concatenate([parts[s][i].cpu().numpy() for s in order])
                      for i in range(n_t)])
    import torch.distributed as dist

    if list(mesh.owners) != sorted(mesh.owners):
        raise ValueError("fetch: a multi-process mesh's shards must be in rank order")
    t0 = time.monotonic()
    n_dev, world = len(mesh.devices), mesh.processes
    n_t = len(parts[order[0]]) if order else 0
    n_t = int(all_reduce_host(torch.tensor([n_t]), "max")[0])
    # Per position: each shard's rows, then the type code + 1, then the
    # trailing dims + 1 (0: absent); MAX-reduced, as only owners write.
    meta = torch.zeros((n_dev + 1 + _MAX_DIMS, n_t), dtype=torch.int64)
    for s in order:
        for i, t in enumerate(parts[s]):
            meta[s, i] = t.shape[0]
            meta[n_dev, i] = _TYPES.index(t.dtype) + 1
            for j, dim in enumerate(t.shape[1:]):
                meta[n_dev + 1 + j, i] = dim + 1
    meta = all_reduce_host(meta, "max").tolist()
    sent, outs = 0, []
    for i in range(n_t):
        dtype = _TYPES[meta[n_dev][i] - 1]
        tail = tuple([meta[n_dev + 1 + j][i] - 1 for j in range(_MAX_DIMS)
                      if meta[n_dev + 1 + j][i] > 0])
        per_row = int(np.prod(tail)) if tail else 1
        sizes = [sum(meta[s][i] for s in range(n_dev) if mesh.owners[s] == r) * per_row
                 for r in range(world)]
        # Each part goes to the wire device before the join: a rank's
        # shards may lie on several devices.
        buf = (torch.cat([_wire(parts[s][i].reshape(-1), mesh) for s in order]) if order
               else torch.zeros(0, dtype=torch.uint8 if dtype == torch.bool else dtype,
                                device=_wire_device(mesh)))
        if buf.numel() < max(sizes):
            pad = torch.zeros(max(sizes) - buf.numel(), dtype=buf.dtype, device=buf.device)
            buf = torch.cat([buf, pad])
        got = [torch.empty_like(buf) for _ in range(world)]
        dist.all_gather(got, buf, group=mesh.group)
        sent += buf.numel() * buf.element_size()
        host = [g[: sizes[r]].cpu() for r, g in enumerate(got)]
        if dtype == torch.bool:
            host = [h.to(torch.bool) for h in host]
        outs.append(np.concatenate([h.numpy() for h in host]).reshape((-1, *tail)))
    _count("gather", sent, t0)
    return tuple(outs)


def all_reduce_host(t: torch.Tensor, op: str = "max") -> torch.Tensor:
    """A host tensor reduced in place across every rank on the default
    (gloo) group: the helpers' own metadata, never data."""
    import torch.distributed as dist

    ops = {"max": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM}
    dist.all_reduce(t, op=ops[op])
    return t
