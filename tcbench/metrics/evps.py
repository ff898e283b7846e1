"""``evps``: LDBC Graphalytics' edges and vertices per second.

The sum of |V| + |E| over the jobs completed in the window, over the
window's seconds on the host clock: all the work over all the time.
"""


def read(r):
    if not r.jobs or r.window_s <= 0:
        return None
    return (r.n_vertices + r.n_edges) * len(r.jobs) / r.window_s
