"""trilint fixture: deliberate backend-protocol violations (B1-B4), torch flavor.

Parsed, never imported.  Self-contained protocol root so the pass's
in-module chain resolution has something to walk; the chunk methods return
tensors as the port's backends do.
"""

import torch


def register_backend(name, factory):
    pass


class KernelBackend:
    capabilities: frozenset = frozenset()

    def plan(self, work, budget, *, bucket_pow2=False):
        raise NotImplementedError

    def count_chunk(self, adj, chunk):
        raise NotImplementedError

    def per_node_chunk(self, adj, chunk, n_out):
        raise NotImplementedError

    def support_chunk(self, adj, chunk, m_out):
        raise NotImplementedError


class OverpromisingCsrBackend(KernelBackend):
    # B1: declares per_node but never implements per_node_chunk.
    # B3: implements support_chunk but does not declare "support".
    capabilities = frozenset({"count", "per_node"})

    def plan(self, work, budget, *, bucket_pow2=False):
        return None

    def count_chunk(self, adj, chunk):
        return torch.zeros((1,), dtype=torch.int32)

    def support_chunk(self, adj, chunk, m_out):
        return torch.zeros((m_out,), dtype=torch.int32)


class UndeclaredStripeBackend:
    # B2: registered with no capabilities table at all; B4: no plan.
    def count_chunk(self, adj, chunk):
        return torch.zeros((1,), dtype=torch.int32)


class CompliantBackend(KernelBackend):
    # Compliant: declares exactly what it implements.
    capabilities = frozenset({"count"})

    def plan(self, work, budget, *, bucket_pow2=False):
        return None

    def count_chunk(self, adj, chunk):
        return torch.zeros((1,), dtype=torch.int32)


register_backend("overpromising", lambda **kw: OverpromisingCsrBackend(**kw))
register_backend("undeclared", UndeclaredStripeBackend)
register_backend("compliant", lambda **_: CompliantBackend())
