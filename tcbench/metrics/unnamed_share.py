"""``unnamed_share``: job time that no phase of the engine names.

The time inside the ``tcbench.job.*`` host ranges that no engine phase
range (:data:`tcbench.spans.PHASES`) covers, over the traced window.
"""
from tcbench.spans import unnamed_share


def read(r):
    return unnamed_share(r)
