"""Single-process node shell (port of the JAX package's node package):
mempool, block production, block store and the serving reads.

``Block``, ``Mempool`` and ``Node`` are resolved lazily (PEP 562), as in
the JAX package, so importing ``node.eds_cache`` or ``node.consensus``
alone does not import the prover stack or the App.
"""

_NODE_NAMES = ("Block", "Mempool", "Node")


def __getattr__(name):
    if name in _NODE_NAMES:
        from celestia_tpu_torch.node import node as _node

        return getattr(_node, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_NODE_NAMES))
