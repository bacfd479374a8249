"""Operator tools (port of the JAX package's tools/; reference: tools/).

Submodule re-exports are LAZY (PEP 562, same shape as the `app`
package), so importing the package pulls in none of them. The port has
``tsdb`` (the longitudinal recorder) so far.
"""

_EXPORTS = {
    "tsdb": ("celestia_tpu_torch.tools.tsdb", None),
}


def __getattr__(name: str):
    try:
        module, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(name) from None
    import importlib

    mod = importlib.import_module(module)
    return mod if attr is None else getattr(mod, attr)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
