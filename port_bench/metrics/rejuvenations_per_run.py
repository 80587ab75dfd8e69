"""Rejuvenations a posterior, over the window's calls: each call's own
``StepInfo.rejuvenated`` (a program counter)."""


def read(ctx):
    recs = [rec for _, _, rec in ctx.window["calls"]]
    if not recs or "rejuvenations" not in recs[0]:
        return None
    return sum(rec["rejuvenations"] for rec in recs) / len(recs)
