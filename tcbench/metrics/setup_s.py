"""``setup_s``: process start to the window's start on the host clock
(imports, kernel load or build, graph generation, the warm-up job)."""


def read(r):
    return r.setup_s
