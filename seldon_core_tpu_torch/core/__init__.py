"""The message model, codecs, errors and tensor bridge.

The names below load with their modules on first use (PEP 562), so that a
process which needs one light module (the load generator's npy codec)
does not import torch through the others.
"""

import importlib

_EXPORTS = {
    "APIException": "errors",
    "ErrorCode": "errors",
    "DefaultData": "message",
    "Feedback": "message",
    "Meta": "message",
    "SeldonMessage": "message",
    "Status": "message",
    "StatusFlag": "message",
    "message_from_json": "codec_json",
    "message_to_json": "codec_json",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
