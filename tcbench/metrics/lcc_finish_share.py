"""``lcc_finish_share``: the LCC job's own host work as a share of the window.

The union of the ``engine.degrees`` (the degree histogram) and
``engine.lcc_finish`` (the coefficients from the counts) host ranges
over the traced window.
"""
from tcbench.spans import phase_share


def read(r):
    return phase_share(r, "engine.degrees", "engine.lcc_finish")
