"""Borůvka rounds: the mean over the window's ``boruvka.round`` spans of
the time inside a round in which the card ran nothing (its wall less the
profile's busy time under it): the round's host work that the card waits
for, ms."""

from portbench import program_spans


def record():
    return program_spans.record()


def read(ctx):
    tl = program_spans.timeline(ctx)
    idle = tl.idle_us("boruvka.round") if tl else None
    return sum(idle) / len(idle) / 1e3 if idle else None
