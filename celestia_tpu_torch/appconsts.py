"""Protocol constants (a copy of the JAX package's appconsts).

Reference semantics: pkg/appconsts/global_consts.go, initial_consts.go,
consensus_consts.go, v1/app_consts.go, v2/app_consts.go, versioned_consts.go.
"""

from celestia_tpu_torch.namespace import (  # noqa: F401
    NAMESPACE_ID_SIZE,
    NAMESPACE_SIZE,
    NAMESPACE_VERSION_SIZE,
)

SHARE_SIZE = 512
SHARE_INFO_BYTES = 1
SEQUENCE_LEN_BYTES = 4
SHARE_VERSION_ZERO = 0
DEFAULT_SHARE_VERSION = SHARE_VERSION_ZERO
MAX_SHARE_VERSION = 127
COMPACT_SHARE_RESERVED_BYTES = 4

FIRST_COMPACT_SHARE_CONTENT_SIZE = (
    SHARE_SIZE
    - NAMESPACE_SIZE
    - SHARE_INFO_BYTES
    - SEQUENCE_LEN_BYTES
    - COMPACT_SHARE_RESERVED_BYTES
)  # 474
CONTINUATION_COMPACT_SHARE_CONTENT_SIZE = (
    SHARE_SIZE - NAMESPACE_SIZE - SHARE_INFO_BYTES - COMPACT_SHARE_RESERVED_BYTES
)  # 478
FIRST_SPARSE_SHARE_CONTENT_SIZE = (
    SHARE_SIZE - NAMESPACE_SIZE - SHARE_INFO_BYTES - SEQUENCE_LEN_BYTES
)  # 478
CONTINUATION_SPARSE_SHARE_CONTENT_SIZE = (
    SHARE_SIZE - NAMESPACE_SIZE - SHARE_INFO_BYTES
)  # 482

MIN_SQUARE_SIZE = 1
MIN_SHARE_COUNT = MIN_SQUARE_SIZE * MIN_SQUARE_SIZE
BOND_DENOM = "utia"

HASH_LENGTH = 32  # SHA-256

# --- Versioned constants (ref: pkg/appconsts/v{1,2}/app_consts.go) ---
LATEST_VERSION = 2

_SQUARE_SIZE_UPPER_BOUND = {1: 128, 2: 128}
_SUBTREE_ROOT_THRESHOLD = {1: 64, 2: 64}

DEFAULT_SQUARE_SIZE_UPPER_BOUND = 128
DEFAULT_SUBTREE_ROOT_THRESHOLD = 64


def square_size_upper_bound(app_version: int) -> int:
    """ref: pkg/appconsts/versioned_consts.go:20"""
    return _SQUARE_SIZE_UPPER_BOUND.get(app_version, DEFAULT_SQUARE_SIZE_UPPER_BOUND)


def subtree_root_threshold(app_version: int) -> int:
    """ref: pkg/appconsts/versioned_consts.go:27"""
    return _SUBTREE_ROOT_THRESHOLD.get(app_version, DEFAULT_SUBTREE_ROOT_THRESHOLD)


# --- Governance-modifiable initial constants (ref: initial_consts.go) ---
DEFAULT_GOV_MAX_SQUARE_SIZE = 64
DEFAULT_MAX_BYTES = (
    DEFAULT_GOV_MAX_SQUARE_SIZE
    * DEFAULT_GOV_MAX_SQUARE_SIZE
    * CONTINUATION_SPARSE_SHARE_CONTENT_SIZE
)
DEFAULT_GAS_PER_BLOB_BYTE = 8
DEFAULT_MIN_GAS_PRICE = 0.1
DEFAULT_UNBONDING_TIME_SECONDS = 3 * 7 * 24 * 3600

# --- Consensus timing (ref: consensus_consts.go) ---
TIMEOUT_PROPOSE_SECONDS = 10
TIMEOUT_COMMIT_SECONDS = 11
GOAL_BLOCK_TIME_SECONDS = 15
