"""The node's serving surface (port of the JAX package's node package, as
far as serving reads go): ``Node`` answers DAS samples from the paged EDS
cache of ``node.eds_cache``.

``Node`` is resolved lazily (PEP 562), as in the JAX package, so importing
``node.eds_cache`` alone does not import the prover stack.
"""

_NODE_NAMES = ("Node",)


def __getattr__(name):
    if name in _NODE_NAMES:
        from celestia_tpu_torch.node import node as _node

        return getattr(_node, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_NODE_NAMES))
