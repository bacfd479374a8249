"""The application layer (ABCI boundary) of the port.

The App and Context re-exports are lazy (PEP 562): ``app.app`` pulls the
whole state machine (crypto, the x/ modules), while the light submodules
(``app.calibration``, ``app.proposal``) stay importable without it.
"""

_EXPORTS = {
    "App": ("celestia_tpu_torch.app.app", "App"),
    "GENESIS_CHAIN_ID": ("celestia_tpu_torch.app.app", "GENESIS_CHAIN_ID"),
    "Context": ("celestia_tpu_torch.app.context", "Context"),
    "GasMeter": ("celestia_tpu_torch.app.context", "GasMeter"),
    "OutOfGasError": ("celestia_tpu_torch.app.context", "OutOfGasError"),
}


def __getattr__(name: str):
    try:
        module, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(name) from None
    import importlib

    return getattr(importlib.import_module(module), attr)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
