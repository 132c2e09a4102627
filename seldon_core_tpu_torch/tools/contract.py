"""Contract tester: random-input conformance testing for a served model.

Port of ``seldon_core_tpu/tools/contract.py``: REST with the standard
library only; ``--grpc`` sends each prediction as ``Seldon.Predict``
(``grpc_request``, with the token as ``oauth_token`` metadata when
``--oauth-key`` is given, the gateway's gRPC auth) and imports ``grpc``
and ``google.protobuf`` only then. A feedback always goes over REST, as in
the JAX tool.

Parity (C23): reference wrappers/tester.py — reads a ``contract.json`` data
contract (features with name/dtype/ftype/range/values/repeat/shape), builds
random batches matching the declared schema (generate_batch:30), and fires
REST or gRPC predictions at a running endpoint (run:116-152), printing each
request/response. Same contract schema, including the "inf" range sentinel.

CLI:
    python -m seldon_core_tpu_torch.tools.contract contract.json HOST PORT \
        [--endpoint predict|send-feedback] [--batch-size N] [-n ROUNDS] \
        [--grpc] [--prnt] [--oauth-key K --oauth-secret S [--oauth-port P]]
"""

from __future__ import annotations

import argparse
import json
import urllib.request
from typing import Any

import numpy as np


def _bound(v: Any, default: float) -> float:
    if v in ("inf", "-inf", None):
        return default
    return float(v)


def generate_column(feature: dict, batch_size: int, rng: np.random.Generator):
    """One contract feature -> ndarray column(s) (tester.py generate_batch)."""
    repeat = int(feature.get("repeat", 1))
    ftype = feature.get("ftype", "continuous")
    dtype = feature.get("dtype", "FLOAT")
    shape = feature.get("shape")
    if shape:  # image-style features declare a full shape (deep_mnist)
        n = int(np.prod([int(s) for s in shape]))
        repeat = n
    if ftype == "categorical":
        values = feature.get("values", [0, 1])
        idx = rng.integers(0, len(values), size=(batch_size, repeat))
        col = np.asarray(values, dtype=object)[idx]
        try:
            col = col.astype(np.float64)
        except (ValueError, TypeError):
            pass  # string categories stay strings (ndarray payload)
        return col
    lo = _bound(feature.get("range", ["inf", "inf"])[0], -1.0)
    hi = _bound(feature.get("range", ["inf", "inf"])[1], 1.0)
    col = rng.uniform(lo, hi, size=(batch_size, repeat))
    if dtype == "INT":
        col = np.round(col).astype(np.int64)
    return col


def generate_batch(contract: dict, batch_size: int, rng: np.random.Generator):
    """Returns (names, batch array/list-of-rows)."""
    names: list[str] = []
    cols = []
    for feature in contract["features"]:
        col = generate_column(feature, batch_size, rng)
        repeat = col.shape[1]
        base = feature["name"]
        names.extend([base] if repeat == 1 else [f"{base}_{i}" for i in range(repeat)])
        cols.append(col)
    if any(c.dtype == object for c in cols):
        # mixed string/numeric rows: coerce numpy scalars to JSON-safe
        # Python types (np.float64 is not json-serializable)
        def py(v):
            return v.item() if isinstance(v, np.generic) else v

        rows = [
            [py(c[i, j]) for c in cols for j in range(c.shape[1])]
            for i in range(batch_size)
        ]
        return names, rows
    return names, np.concatenate(cols, axis=1)


def rest_request(host: str, port: int, payload: dict, endpoint: str, token: str | None):
    path = "predictions" if endpoint == "predict" else "feedback"
    headers = {"Content-Type": "application/json"}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    req = urllib.request.Request(
        f"http://{host}:{port}/api/v0.1/{path}",
        json.dumps(payload).encode(),
        headers,
    )
    with urllib.request.urlopen(req) as resp:
        return json.loads(resp.read())


def grpc_request(host: str, port: int, payload: dict, token: str | None) -> dict:
    """One ``Seldon.Predict`` over gRPC; the reply as the proto's JSON."""
    import grpc
    from google.protobuf import json_format

    from seldon_core_tpu_torch.core.codec_json import message_from_dict
    from seldon_core_tpu_torch.core.codec_proto import message_to_proto
    from seldon_core_tpu_torch.proto.services import ServiceStub

    with grpc.insecure_channel(f"{host}:{port}") as channel:
        reply = ServiceStub(channel, "Seldon").Predict(
            message_to_proto(message_from_dict(payload)), metadata=(("oauth_token", token),) if token else ()
        )
    return json.loads(json_format.MessageToJson(reply))


def fetch_token(host: str, port: int, key: str, secret: str) -> str:
    body = f"grant_type=client_credentials&client_id={key}&client_secret={secret}"
    req = urllib.request.Request(
        f"http://{host}:{port}/oauth/token",
        body.encode(),
        {"Content-Type": "application/x-www-form-urlencoded"},
    )
    with urllib.request.urlopen(req) as resp:
        return json.loads(resp.read())["access_token"]


def run(
    contract: dict,
    host: str,
    port: int,
    *,
    rounds: int = 1,
    batch_size: int = 1,
    endpoint: str = "predict",
    use_grpc: bool = False,
    oauth_key: str = "",
    oauth_secret: str = "",
    oauth_port: int | None = None,
    seed: int | None = None,
    prnt: bool = False,
) -> list[dict]:
    rng = np.random.default_rng(seed)
    token = (
        fetch_token(host, oauth_port or port, oauth_key, oauth_secret)
        if oauth_key
        else None
    )
    responses = []
    for _ in range(rounds):
        names, batch = generate_batch(contract, batch_size, rng)
        data = batch.tolist() if isinstance(batch, np.ndarray) else batch
        payload = {"data": {"names": names, "ndarray": data}}
        if endpoint == "send-feedback":
            payload = {
                "request": payload,
                "response": {},
                "reward": float(rng.random()),
            }
        if prnt:
            print("SENDING:", json.dumps(payload)[:400])
        out = (
            grpc_request(host, port, payload, token)
            if use_grpc and endpoint == "predict"
            else rest_request(host, port, payload, endpoint, token)
        )
        if prnt:
            print("RECEIVED:", json.dumps(out)[:400])
        responses.append(out)
    return responses


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("contract")
    p.add_argument("host")
    p.add_argument("port", type=int)
    p.add_argument("--endpoint", default="predict", choices=["predict", "send-feedback"])
    p.add_argument("-b", "--batch-size", type=int, default=1)
    p.add_argument("-n", "--n-requests", type=int, default=1)
    p.add_argument("--grpc", action="store_true", help="predict over gRPC (Seldon.Predict)")
    p.add_argument("--prnt", action="store_true", help="print requests/responses")
    p.add_argument("--oauth-key", default="")
    p.add_argument("--oauth-secret", default="")
    p.add_argument("--oauth-port", type=int, default=None)
    args = p.parse_args(argv)
    with open(args.contract) as f:
        contract = json.load(f)
    run(
        contract,
        args.host,
        args.port,
        rounds=args.n_requests,
        batch_size=args.batch_size,
        endpoint=args.endpoint,
        use_grpc=args.grpc,
        oauth_key=args.oauth_key,
        oauth_secret=args.oauth_secret,
        oauth_port=args.oauth_port,
        prnt=args.prnt,
    )


if __name__ == "__main__":
    main()
