"""Typed message model — the framework-wide data contract.

Port of ``seldon_core_tpu/core/message.py``: the reference wire contract
(SeldonMessage / DefaultData / Meta / Status / Feedback). ``DefaultData``
holds a live array — a numpy array or a torch tensor, on the host or the
card — so a message flows through an in-process graph without re-encoding.
The JSON codec (``codec_json.py``) runs only at the process edge.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

Array = Any  # np.ndarray | torch.Tensor


class StatusFlag(enum.IntEnum):
    SUCCESS = 0
    FAILURE = 1


@dataclass(frozen=True)
class Status:
    code: int = 200
    info: str = ""
    reason: str = ""
    status: StatusFlag = StatusFlag.SUCCESS


class DataKind(enum.Enum):
    """Which wire form DefaultData serialises back to (tensor vs ndarray)."""

    TENSOR = "tensor"
    NDARRAY = "ndarray"


@dataclass(frozen=True)
class DefaultData:
    """Named tensor payload; ``kind`` records the client's JSON encoding so
    responses round-trip in the same form."""

    names: tuple[str, ...] = ()
    array: Array | None = None
    kind: DataKind = DataKind.TENSOR

    def with_array(self, array: Array, names: Sequence[str] | None = None) -> "DefaultData":
        return DefaultData(
            names=tuple(names) if names is not None else self.names,
            array=array,
            kind=self.kind,
        )


@dataclass(frozen=True)
class Meta:
    """Request metadata. ``routing`` records, per graph-node name, which
    child index a ROUTER chose (-1 = all children)."""

    puid: str = ""
    tags: Mapping[str, Any] = field(default_factory=dict)
    routing: Mapping[str, int] = field(default_factory=dict)
    request_path: Mapping[str, str] = field(default_factory=dict)

    def merged_with(self, other: "Meta") -> "Meta":
        """Tags union-merged (other wins on conflict), puid preserved from
        the request, routing and requestPath entries accumulate."""
        if other is self:
            return self
        if not (other.tags or other.routing or other.request_path) and (
            self.puid or not other.puid
        ):
            return self
        if not (self.tags or self.routing or self.request_path) and not self.puid:
            return other
        return Meta(
            puid=self.puid or other.puid,
            tags={**self.tags, **other.tags},
            routing={**self.routing, **other.routing},
            request_path={**self.request_path, **other.request_path},
        )


@dataclass(frozen=True)
class SeldonMessage:
    """The one message type every graph node consumes and produces. At most
    one of data/bin_data/str_data/json_data is set (oneof semantics)."""

    data: DefaultData | None = None
    bin_data: bytes | None = None
    str_data: str | None = None
    json_data: Any | None = None
    meta: Meta = field(default_factory=Meta)
    status: Status | None = None

    def __post_init__(self) -> None:
        set_arms = [
            x is not None for x in (self.data, self.bin_data, self.str_data, self.json_data)
        ]
        if sum(set_arms) > 1:
            raise ValueError("SeldonMessage: at most one data arm may be set (oneof)")

    @staticmethod
    def from_array(
        array: Array,
        names: Sequence[str] = (),
        meta: Meta | None = None,
        kind: DataKind = DataKind.TENSOR,
    ) -> "SeldonMessage":
        return SeldonMessage(
            data=DefaultData(names=tuple(names), array=array, kind=kind),
            meta=meta or Meta(),
        )

    @property
    def array(self) -> Array | None:
        return self.data.array if self.data is not None else None

    @property
    def names(self) -> tuple[str, ...]:
        return self.data.names if self.data is not None else ()

    def with_array(self, array: Array, names: Sequence[str] | None = None) -> "SeldonMessage":
        """Replace the payload with a tensor (clears the other oneof arms),
        keeping meta, status and the data kind."""
        base = self.data if self.data is not None else DefaultData()
        return SeldonMessage(
            data=base.with_array(array, names), meta=self.meta, status=self.status
        )

    def with_meta(self, meta: Meta) -> "SeldonMessage":
        if meta is self.meta:
            return self
        return SeldonMessage(
            data=self.data,
            bin_data=self.bin_data,
            str_data=self.str_data,
            json_data=self.json_data,
            meta=meta,
            status=self.status,
        )

    def with_array_meta(
        self, array: Array, meta: Meta, names: Sequence[str] | None = None
    ) -> "SeldonMessage":
        base = self.data if self.data is not None else DefaultData()
        return SeldonMessage(
            data=base.with_array(array, names), meta=meta, status=self.status
        )


@dataclass(frozen=True)
class Feedback:
    """Reward feedback on an earlier prediction."""

    request: SeldonMessage | None = None
    response: SeldonMessage | None = None
    reward: float = 0.0
    truth: SeldonMessage | None = None
