"""The protocol constants of the extension slice.

Reference semantics: pkg/appconsts/global_consts.go, initial_consts.go,
v1/app_consts.go, v2/app_consts.go (a copy of the subset the port needs).
"""

from celestia_tpu_torch.namespace import NAMESPACE_SIZE  # noqa: F401

SHARE_SIZE = 512

MIN_SQUARE_SIZE = 1
MIN_SHARE_COUNT = MIN_SQUARE_SIZE * MIN_SQUARE_SIZE

HASH_LENGTH = 32  # SHA-256

# protocol maximum (pkg/appconsts/v{1,2}/app_consts.go)
DEFAULT_SQUARE_SIZE_UPPER_BOUND = 128
# governance default (pkg/appconsts/initial_consts.go)
DEFAULT_GOV_MAX_SQUARE_SIZE = 64
