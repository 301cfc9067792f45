"""The program's own counters of each solve (``step.result.stats``: the
masked PANOC loop's trips, host seconds and seconds in its all-lanes-done
checks), as the per-layer metrics that read them take them."""


def window_stats(run):
    """Each window step's solve stats, or None where a step's result
    carries none (a program that keeps no such counters)."""
    stats = [getattr(s.result, "stats", None) for s in run.steps]
    if not stats or any(s is None for s in stats):
        return None
    return stats
