"""Refine dispatches of the window that replayed a built program, over all
of them (``pipeline/graphs.stats``: replays / (replays + eager))."""

LAYER = "refine programs"
MOVES = "subread_bases_per_s"
UNIT = "%"


def read(obs):
    replays = sum(v.get("replays", 0) for v in obs.graph_stats.values())
    eager = sum(v.get("eager", 0) for v in obs.graph_stats.values())
    if not replays + eager:
        return None
    return 100.0 * replays / (replays + eager)
