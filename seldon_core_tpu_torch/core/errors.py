"""Error taxonomy.

Parity: reference engine APIException enum
(engine/src/main/java/io/seldon/engine/exception/APIException.java) and the
api-frontend variant (APIFE_* codes), plus the Python microservice error JSON
(wrappers/python/microservice.py:29-30). The numeric codes and names are kept
so clients/dashboards written against the reference keep working.
"""

from __future__ import annotations

import enum


class ErrorCode(enum.Enum):
    # (code, http_status, message) — engine taxonomy
    ENGINE_INVALID_JSON = (101, 400, "Invalid JSON")
    ENGINE_INVALID_ENDPOINT_URL = (102, 500, "Invalid endpoint URL")
    ENGINE_MICROSERVICE_ERROR = (103, 500, "Microservice error")
    ENGINE_INVALID_ABTEST = (104, 500, "Error happened in AB Test routing")
    ENGINE_INVALID_ROUTING = (105, 500, "Invalid graph routing")
    ENGINE_INVALID_RESPONSE = (106, 500, "Invalid microservice response")
    # api-frontend taxonomy
    APIFE_INVALID_JSON = (201, 400, "Invalid JSON")
    APIFE_INVALID_ENDPOINT_URL = (202, 500, "Invalid endpoint URL")
    APIFE_MICROSERVICE_ERROR = (203, 500, "Microservice error")
    APIFE_NO_RUNNING_DEPLOYMENT = (204, 500, "No Running Deployment")
    APIFE_GRPC_NO_PRINCIPAL_FOUND = (205, 401, "No Principal found")
    # new-framework additions (outside reference ranges)
    TPU_COMPILE_ERROR = (301, 500, "XLA compilation failed")
    TPU_SHAPE_BUCKET_OVERFLOW = (302, 400, "Request exceeds largest compiled batch bucket")
    REQUEST_TIMEOUT = (303, 504, "Request timed out in batching queue")
    REQUEST_DEADLINE_EXCEEDED = (304, 504, "Request deadline budget exhausted")
    ENGINE_BREAKER_OPEN = (305, 503, "Circuit breaker open for endpoint")

    @property
    def code(self) -> int:
        return self.value[0]

    @property
    def http_status(self) -> int:
        return self.value[1]

    @property
    def message(self) -> str:
        return self.value[2]


class APIException(Exception):
    def __init__(
        self,
        error: ErrorCode,
        info: str = "",
        *,
        retry_after_s: float | None = None,
        retryable: bool | None = None,
    ):
        self.error = error
        self.info = info
        # when set (open circuit breaker), the wire sends it as an HTTP
        # Retry-After header so clients back off instead of hammering
        self.retry_after_s = retry_after_s
        # the resilience layer's verdict, when the raiser knows better than
        # the code: a remote unit's 4xx travels as ENGINE_MICROSERVICE_ERROR
        # but is deterministic, so it is never replayed nor counted against
        # the endpoint's breaker. None: classified by code.
        self.retryable = retryable
        super().__init__(f"{error.name}({error.code}): {error.message} {info}".rstrip())

    def retry_after_header(self) -> str | None:
        """Value of the HTTP Retry-After header, or None: whole seconds,
        rounded up, at least 1."""
        if self.retry_after_s is None:
            return None
        return str(max(1, int(self.retry_after_s + 0.999)))

    def to_status_json(self) -> dict:
        """The JSON error body shape the reference engine returns."""
        return {
            "code": self.error.code,
            "info": self.info,
            "reason": self.error.message,
            "status": "FAILURE",
        }
