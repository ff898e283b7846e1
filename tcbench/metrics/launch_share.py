"""``launch_share``: the engine's chunk loop as a share of the window.

The union of the ``engine.launch`` host ranges (every chunk's uploads and
launch, and the per-node sum) over the traced window.
"""
from tcbench.spans import phase_share


def read(r):
    return phase_share(r, "engine.launch")
