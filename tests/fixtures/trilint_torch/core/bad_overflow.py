"""trilint fixture: deliberate overflow-discipline violations (O1/O2/O3), torch forms.

Never imported — parsed from disk by tests/test_torch_trilint.py to prove the
port's `overflow` pass fires.  Lives under a fake `core/` directory so the
counting-path prefix rules apply.  The compliant twins at the end must not
be flagged.
"""

import numpy as np
import torch

from repro_torch.distributed.compression import ensure_fits_int32


def chunk_total(hits):
    # O1: an explicit int32 accumulation outside a chunk-partial site.
    return hits.sum(dtype=torch.int32)


def running_offsets(deg):
    # O1: an int32 prefix sum of degrees (offsets reach the edge count).
    return torch.cumsum(deg, 0, dtype=torch.int32)


def scatter_incidences(u, inc, n):
    # O1: index_add_ into a tensor made int32 in the same function.
    out = torch.zeros((n,), dtype=torch.int32)
    out.index_add_(0, u, inc)
    return out


def host_fold_total(hits):
    # O2: int() of an int32 accumulation wraps on the device first.
    return int(hits.sum(dtype=torch.int32))


def host_fold_item(hits):
    # O2: .item() of an int32 accumulation.
    return torch.sum(hits, dtype=torch.int32).item()


def host_fold_numpy(per_node):
    # O2: the reference's numpy form, a fold with no widening.
    return int(per_node.sum())


def bucket_indices(mask):
    # O3: index-scale narrowing (nonzero output) with no bound guard.
    idx = torch.nonzero(mask)[:, 0]
    return idx.to(torch.int32)


def degree_histogram(src, n):
    # O3: bincount counts reach the edge count; .int() narrows unguarded.
    return torch.bincount(src, minlength=n).int()


def row_offsets(src, ids):
    # O3: searchsorted straight into int32, unguarded.
    return torch.searchsorted(src, ids, out_int32=True)


# --- compliant forms: not flagged ----------------------------------------


def total_int64(hits):
    # torch.sum of int32 accumulates in int64 unless dtype= says otherwise
    # (folded through int() it still takes an explicit dtype=, as O2 cannot
    # tell a tensor from an array)
    return hits.sum()


def total_widened(hits):
    return int(hits.sum(dtype=torch.int64))


def guarded_indices(mask):
    idx = torch.nonzero(mask)[:, 0]
    ensure_fits_int32(idx.numel(), "bucket indices")
    return idx.to(torch.int32)


def chunk_partial(hits, seg):
    # trilint: ok[overflow] — a chunk partial: each segment sum is at most seg
    return hits.reshape(-1, seg).sum(dim=1, dtype=torch.int32)


def host_wide(per_node):
    return int(np.asarray(per_node).sum(dtype=np.int64))
