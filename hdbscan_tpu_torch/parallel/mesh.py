"""The device mesh of the sharded programs — the port of
``parallel/mesh.py``.

The reference's sharded fit is single-controller: one process drives a 1-D
``jax.sharding.Mesh`` through ``shard_map``. The port keeps that shape
without a JAX mesh: a :class:`Mesh` is an ordered list of torch devices,
shard ``s`` of every sharded array lives on ``mesh.devices[s]``, and the one
process launches each shard's kernels on its device. A list may name one
device several times — several shards on one card, the analog of the
reference's forced multi-device CPU mesh — and on a machine with several
cards it names each card once. There is no ``NamedSharding``: a shard's
tensors simply lie on its device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: shard ``s`` lives on ``devices[s]``."""

    devices: tuple

    @property
    def root(self) -> torch.device:
        """The first shard's device: where cross-shard reductions and the
        gathered edge buffers land."""
        return self.devices[0]

    def distinct(self) -> list:
        """The mesh's devices without repeats, in shard order."""
        return list(dict.fromkeys(self.devices))


def get_mesh(devices: list | None = None) -> Mesh:
    """1-D mesh over ``devices`` (default: every visible card, one shard
    each). Raises when no device is given and no card is present, and on
    a list that mixes the CPU and cards: a mesh's shards all take the
    kernels or all their plain versions, as a JAX mesh is of one
    platform."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: pass get_mesh([torch.device('cpu')] * D) "
                "to shard on the CPU"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in devices}) > 1:
        raise ValueError(f"a mesh's devices must be all CPU or all CUDA, got "
                         f"{[str(d) for d in devices]}")
    return Mesh(devices)


def spans_cards(mesh: Mesh | None) -> bool:
    """A mesh of two or more distinct CUDA devices: where ``auto`` takes
    the sharded and ring engines (the reference's multi-device TPU rule)."""
    if mesh is None:
        return False
    cards = mesh.distinct()
    return len(cards) > 1 and all(d.type == "cuda" for d in cards)


def device_count(mesh: Mesh) -> int:
    """Number of shards on the (1-D) mesh."""
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


def fetch(shards) -> np.ndarray:
    """Per-shard tensors, in shard order, concatenated on the host."""
    return np.concatenate([t.cpu().numpy() for t in shards])
