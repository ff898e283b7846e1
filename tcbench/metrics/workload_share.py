"""``workload_share``: the engine's workload build as a share of the window.

The union of the ``engine.workload`` host ranges (``workload_from_csr``:
the host copies of the CSR's sources, columns and out-degrees) over the
traced window.
"""
from tcbench.spans import phase_share


def read(r):
    return phase_share(r, "engine.workload")
