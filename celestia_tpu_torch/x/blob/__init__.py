"""x/blob — the PayForBlobs module."""

from .types import (  # noqa: F401
    BYTES_PER_BLOB_INFO,
    PFB_GAS_FIXED_COST,
    MsgPayForBlobs,
    estimate_gas,
    gas_to_consume,
    new_msg_pay_for_blobs,
    validate_blob_namespace,
    validate_blob_tx,
    validate_blobs,
)
from .keeper import BlobKeeper, Params  # noqa: F401
