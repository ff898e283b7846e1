"""trilint fixture: deliberate stats-lifecycle violation (S1).

Parsed, never imported.  `insert` reaches the `last_update_stats` writer
through a private helper but never clears it on entry, so a batch that
raises leaves the previous batch's stats observable; `delete` is the
compliant twin.
"""


class LeakyStream:
    def __init__(self):
        self.last_update_stats = None

    def _record(self, op, n):
        self.last_update_stats = {"op": op, "n": n}

    def _apply(self, op, edges):
        if len(edges) and edges[0][0] < 0:
            raise ValueError("negative node id")
        self._record(op, len(edges))
        return 0

    def insert(self, edges):
        # S1: no `self.last_update_stats = None` before the private writer.
        return self._apply("insert", edges)

    def delete(self, edges):
        # compliant entry point: clears before running.
        self.last_update_stats = None
        return self._apply("delete", edges)
