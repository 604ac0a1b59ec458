"""The program's own spans of a traced window, as
``bear_tpu_torch.utils.profiling.recorded()`` keeps them (name, start and
end in ns, the index of the enclosing span): durations by name, and a
parent's self time outside its direct children of one name.

Every reader gives None in an untraced run, and where the program recorded
none of the spans it reads (a program without spans reads None).
"""

from __future__ import annotations

from collections import defaultdict


def records(run) -> list:
    """The span records of ``run``'s traced window (indexed as the program
    indexes them), or [] where the run is untraced or the program keeps
    no records."""
    if run.trace is None:
        return []
    from bear_tpu_torch.utils import profiling

    recorded = getattr(profiling, "recorded", None)
    return [] if recorded is None else recorded()


def durations_ms(recs, name: str) -> list:
    """Durations of the closed spans called ``name``, in ms."""
    return [(r.end_ns - r.start_ns) / 1e6 for r in recs
            if r.name == name and r.end_ns is not None]


def mean_ms(run, name: str):
    """Mean duration of the spans called ``name``, in ms, or None."""
    d = durations_ms(records(run), name)
    return sum(d) / len(d) if d else None


def mean_self_ms(run, parent: str, child: str):
    """Mean over the spans called ``parent`` of their duration less that of
    their direct children called ``child``, in ms, or None."""
    recs = records(run)
    inside = defaultdict(float)
    for r in recs:
        if r.name == child and r.parent is not None and r.end_ns is not None:
            inside[r.parent] += (r.end_ns - r.start_ns) / 1e6
    own = [(r.end_ns - r.start_ns) / 1e6 - inside[i] for i, r in enumerate(recs)
           if r.name == parent and r.end_ns is not None]
    return sum(own) / len(own) if own else None
