"""``fold_share``: the engine's fold as a share of the window.

The union of the ``engine.fold`` host ranges over the traced window: host
time, including the wait for the chunks' kernels that the fold's reads
end.
"""
from tcbench.spans import phase_share


def read(r):
    return phase_share(r, "engine.fold")
