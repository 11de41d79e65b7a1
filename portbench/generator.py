"""The one general traffic generator: a traffic file's ``kind`` names a loop
module ``kinds/<kind>.py``, and the file's other keys are that loop's
parameters. The loops build on :class:`Loop` here.

A kind module exports ``Loop`` (a subclass of :class:`Loop`) and
``readings(cell, seed, side, precision, devices, rows)``, the numbers that
set the cell's limits outside a window (``control.py``). A loop's
``setup`` does everything before the window (data, warm-up), ``window``
runs the traffic for the measured seconds and returns the end-to-end
numbers, ``context`` gives the per-layer readers what the loop saw,
``release`` frees the program's state, and ``check`` recomputes a seeded
sample of the window's answers with the reference.
"""

from __future__ import annotations

from types import SimpleNamespace

from portbench import data as datagen, reference


def params_for(config: dict):
    from hdbscan_tpu_torch import HDBSCANParams

    return HDBSCANParams(min_points=config["min_points"],
                         min_cluster_size=config["min_cluster_size"], **config["params"])


def sync(devices) -> None:
    import torch

    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def program_kw(traffic: dict, devices: list) -> dict:
    """``exact.fit``'s placement: one card, or a mesh of every card the cell
    takes where the traffic's ``mesh`` is true."""
    if traffic.get("mesh"):
        from hdbscan_tpu_torch.parallel.mesh import get_mesh

        return {"mesh": get_mesh(devices)}
    return {"device": devices[0]}


def side_fit(cell: dict, data, side: str, precision: str, devices: list):
    """A fit of ``data`` with the cell's parameters: the program's
    (``side="program"``), or the reference's computed in ``precision`` and
    put in its place (``side="control"``); (fit, the reference's dict or None)."""
    config = cell["config"]
    if side == "control":
        other = reference.fit(data, config["min_points"], config["min_cluster_size"], devices,
                              precision)
        return SimpleNamespace(labels=other["labels"], core_distances=other["core"],
                               mst=other["mst"]), other
    from hdbscan_tpu_torch.models import exact

    return exact.fit(data, params_for(config), **program_kw(cell["traffic"], devices)), None


class Loop:
    """What every loop shares; a kind fills in ``setup``, ``window`` and
    ``check``."""

    #: Host phases named in the traced window's profile, (module, function
    #: or Class.method, label); the innermost one names a device idle gap.
    SPANS: tuple = ()

    def __init__(self, cell: dict, seed: int, devices: list):
        self.cell, self.config, self.traffic = cell, cell["config"], cell["traffic"]
        self.seed, self.devices = seed, devices
        self.window_s = 0.0
        self.ref_seconds = None

    def data(self, copy: int):
        return datagen.generate(self.config, self.seed, copy, self.cell["base"])

    def sync(self) -> None:
        sync(self.devices)

    def context(self) -> dict:
        return {}

    def notes(self) -> list:
        """Lines for standard error about the window."""
        return []

    def release(self) -> None:
        pass
