from seldon_core_tpu_torch.core.codec_json import message_from_json, message_to_json
from seldon_core_tpu_torch.core.errors import APIException, ErrorCode
from seldon_core_tpu_torch.core.message import (
    DefaultData,
    Feedback,
    Meta,
    SeldonMessage,
    Status,
    StatusFlag,
)

__all__ = [
    "APIException",
    "DefaultData",
    "ErrorCode",
    "Feedback",
    "Meta",
    "SeldonMessage",
    "Status",
    "StatusFlag",
    "message_from_json",
    "message_to_json",
]
