"""Layered node configuration (port of the JAX package's config.py), the
viper/toml config system analogue. The one difference: ``extend_backend``
takes ``auto|gpu|native|numpy``, the port App's backends.

Reference semantics: app/default_overrides.go:198-271
(DefaultConsensusParams / DefaultConsensusConfig / DefaultAppConfig) and
cmd/celestia-appd/cmd/root.go:82-92 (config is layered: compiled defaults
< config files in <home>/config < CELESTIA_-prefixed environment variables
< command-line flags).

`cli init` writes `config/config.toml` (consensus/node config) and
`config/app.toml` (app config) with the reference's default overrides;
`load_config` reads them back, applying the same precedence order. Files
are TOML (read with stdlib tomllib, written with a minimal emitter —
values here are only str/int/float/bool).
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import tomllib
import typing

from celestia_tpu_torch import appconsts

ENV_PREFIX = "CELESTIA_"


@dataclasses.dataclass
class MempoolConfig:
    """ref: app/default_overrides.go:237-249 (v1 prioritized mempool).
    The reference's TTLDuration (= ttl_num_blocks * goal block time) has no
    analogue here: eviction is purely block-counted."""

    version: str = "v1"
    ttl_num_blocks: int = 5
    # loose DoS upper bound: max-square worth of continuation share bytes
    max_tx_bytes: int = (
        appconsts.DEFAULT_SQUARE_SIZE_UPPER_BOUND
        * appconsts.DEFAULT_SQUARE_SIZE_UPPER_BOUND
        * appconsts.CONTINUATION_SPARSE_SHARE_CONTENT_SIZE
    )

    @property
    def max_txs_bytes(self) -> int:
        """Total-pool cap, derived AFTER overrides so an overridden
        max_tx_bytes propagates (ref: MaxTxsBytes = MaxTxBytes * TTL)."""
        return self.max_tx_bytes * self.ttl_num_blocks


@dataclasses.dataclass
class RpcConfig:
    """ref: app/default_overrides.go:233-235."""

    laddr: str = "127.0.0.1:26657"
    timeout_broadcast_tx_commit_seconds: float = 50.0
    max_body_bytes: int = 8 * 1024 * 1024  # 8 MiB


@dataclasses.dataclass
class ConsensusConfig:
    """config.toml — ref: app/default_overrides.go:230-258."""

    # float() matters: override layers coerce with the default's concrete
    # type, so an int default would truncate fractional values
    timeout_propose_seconds: float = float(appconsts.TIMEOUT_PROPOSE_SECONDS)
    timeout_commit_seconds: float = float(appconsts.TIMEOUT_COMMIT_SECONDS)
    skip_timeout_commit: bool = False
    goal_block_time_seconds: float = float(appconsts.GOAL_BLOCK_TIME_SECONDS)
    tx_indexer: str = "null"
    discard_abci_responses: bool = True
    rpc: RpcConfig = dataclasses.field(default_factory=RpcConfig)
    mempool: MempoolConfig = dataclasses.field(default_factory=MempoolConfig)


@dataclasses.dataclass
class StateSyncConfig:
    """ref: app/default_overrides.go:265-269."""

    snapshot_interval: int = 1500
    snapshot_keep_recent: int = 2


@dataclasses.dataclass
class AppConfig:
    """app.toml — ref: app/default_overrides.go:260-271."""

    min_gas_price: float = appconsts.DEFAULT_MIN_GAS_PRICE
    api_enable: bool = False
    grpc_enable: bool = False
    grpc_web_enable: bool = False
    # ExtendBlock backend: auto | gpu | native | numpy. "auto" picks the
    # card when the App's device is one AND the square is above the
    # measured crossover (app/calibration.py, else app.app.GPU_MIN_SQUARE), else the
    # native C++ runtime, else numpy. This framework's analogue of the
    # reference selecting its codec at pkg/appconsts/global_consts.go:92.
    extend_backend: str = "auto"
    # Measure the per-k gpu/native crossover at startup and persist the
    # table to config/crossover.json (app/calibration.py, ADR-012).
    # Default off: a persisted table (from a previous calibrated start
    # or `--calibrate-crossover`) is loaded either way, so steady-state
    # boots never pay the measurement.
    calibrate_crossover: bool = False
    state_sync: StateSyncConfig = dataclasses.field(default_factory=StateSyncConfig)


@dataclasses.dataclass
class NodeConfig:
    consensus: ConsensusConfig = dataclasses.field(default_factory=ConsensusConfig)
    app: AppConfig = dataclasses.field(default_factory=AppConfig)


# --------------------------------------------------------------------- #
# TOML serialization (flat sections; values are str/int/float/bool)


def _toml_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    return '"' + str(v).replace("\\", "\\\\").replace('"', '\\"') + '"'


def _emit_section(name: str, obj, lines: list[str]) -> None:
    scalars = {
        f.name: getattr(obj, f.name)
        for f in dataclasses.fields(obj)
        if not dataclasses.is_dataclass(getattr(obj, f.name))
    }
    if scalars:
        lines.append(f"[{name}]")
        for k, v in scalars.items():
            lines.append(f"{k} = {_toml_value(v)}")
        lines.append("")
    for f in dataclasses.fields(obj):
        sub = getattr(obj, f.name)
        if dataclasses.is_dataclass(sub):
            _emit_section(f"{name}.{f.name}", sub, lines)


def dumps_toml(obj, root: str) -> str:
    lines: list[str] = []
    _emit_section(root, obj, lines)
    return "\n".join(lines)


def _apply_dict(obj, data: dict) -> None:
    for f in dataclasses.fields(obj):
        if f.name not in data:
            continue
        cur = getattr(obj, f.name)
        if dataclasses.is_dataclass(cur):
            if isinstance(data[f.name], dict):
                _apply_dict(cur, data[f.name])
        else:
            setattr(obj, f.name, type(cur)(data[f.name]))


def _apply_env(obj, prefix: str) -> None:
    """CELESTIA_<SECTION>_<FIELD>=value overrides, e.g.
    CELESTIA_APP_MIN_GAS_PRICE=0.5, CELESTIA_CONSENSUS_MEMPOOL_TTL_NUM_BLOCKS=10."""
    for f in dataclasses.fields(obj):
        cur = getattr(obj, f.name)
        name = f"{prefix}{f.name.upper()}"
        if dataclasses.is_dataclass(cur):
            _apply_env(cur, name + "_")
        elif name in os.environ:
            raw = os.environ[name]
            if isinstance(cur, bool):
                setattr(obj, f.name, raw.lower() in ("1", "true", "yes"))
            else:
                setattr(obj, f.name, type(cur)(raw))


# --------------------------------------------------------------------- #
# The layered loader


def config_dir(home: str | pathlib.Path) -> pathlib.Path:
    return pathlib.Path(home) / "config"


def write_default_configs(home: str | pathlib.Path) -> None:
    """Write config/config.toml + config/app.toml with default overrides
    (what `celestia-appd init` does via WriteConfigFile/WriteAppConfig)."""
    cdir = config_dir(home)
    cdir.mkdir(parents=True, exist_ok=True)
    (cdir / "config.toml").write_text(dumps_toml(ConsensusConfig(), "consensus"))
    (cdir / "app.toml").write_text(dumps_toml(AppConfig(), "app"))


def load_config(
    home: str | pathlib.Path, flag_overrides: dict | None = None
) -> NodeConfig:
    """defaults < toml files < CELESTIA_* env < explicit flag overrides.

    flag_overrides uses dotted paths, e.g. {"app.min_gas_price": 0.5,
    "consensus.mempool.ttl_num_blocks": 3} — only flags the user actually
    passed should appear here (argparse defaults must not mask the files).
    """
    cfg = NodeConfig()
    cdir = config_dir(home)
    for fname, section, target in (
        ("config.toml", "consensus", cfg.consensus),
        ("app.toml", "app", cfg.app),
    ):
        path = cdir / fname
        if path.exists():
            data = tomllib.loads(path.read_text())
            _apply_dict(target, data.get(section, {}))
    _apply_env(cfg.consensus, ENV_PREFIX + "CONSENSUS_")
    _apply_env(cfg.app, ENV_PREFIX + "APP_")
    for dotted, value in (flag_overrides or {}).items():
        obj: typing.Any = cfg
        *path_parts, leaf = dotted.split(".")
        for part in path_parts:
            obj = getattr(obj, part)
        cur = getattr(obj, leaf)
        setattr(obj, leaf, type(cur)(value) if not isinstance(cur, bool) else bool(value))
    return cfg
