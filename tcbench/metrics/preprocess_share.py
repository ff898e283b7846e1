"""``preprocess_share``: the engine's preprocess as a share of the window.

The union of the ``engine.preprocess`` host ranges (the edge array's
upload, the orientation's enqueue) over the traced window.
"""
from tcbench.spans import phase_share


def read(r):
    return phase_share(r, "engine.preprocess")
