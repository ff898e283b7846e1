"""trilint fixture: deliberate decode-narrowing violations (Z1), torch forms.

Never imported — parsed from disk by tests/test_torch_trilint.py to prove the
port's `codec` pass fires on torch narrowings of decoded data.  The guarded
twin at the end must not be flagged.
"""

import numpy as np
import torch

from repro_torch.distributed.compression import ensure_fits_int32
from repro_torch.graphs.io.codec import decode_varints


def unguarded_to(payload, count):
    # Z1: decoded varints narrowed to the kernel dtype with .to(torch.int32).
    vals = torch.from_numpy(decode_varints(payload, count))
    return vals.to(torch.int32)


def unguarded_int(payload, count):
    # Z1: the .int() shorthand.
    return torch.from_numpy(decode_varints(payload, count)).int()


def unguarded_tensor(payload, count):
    # Z1: a constructor with dtype=torch.int32.
    return torch.tensor(decode_varints(payload, count), dtype=torch.int32)


def guarded_to(payload, count):
    # Compliant: bound-checked before narrowing — must not be flagged.
    vals = decode_varints(payload, count)
    ensure_fits_int32(int(vals.max(initial=0)), "decoded column id")
    return torch.from_numpy(vals.astype(np.int64)).to(torch.int32)
