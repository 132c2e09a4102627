"""Audit-stream consumer: read the request/response log back out.

Port of ``seldon_core_tpu/tools/audit_tail.py``; ``kafka://`` stays gated
on its client library, as in the JAX package.

Parity (C17/C28 closing corner): the reference ships a Kafka consumer that
reads the per-client prediction topics and prints the pairs
(kafka/tests/src/read_predictions.py — the smoke test that the audit
pipeline actually records traffic). Same tool here for both sink forms:

    python -m seldon_core_tpu_torch.tools.audit_tail file:///var/log/seldon-audit \
        [--client CLIENT] [--follow] [--json]
    python -m seldon_core_tpu_torch.tools.audit_tail kafka://broker:9092 --client c1

Each record is {ts, request, response} with SeldonMessage JSON bodies —
the same shape the JSONL and Kafka sinks write (gateway/audit.py).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from typing import Iterator


def _iter_jsonl(
    directory: str, client: str | None, follow: bool
) -> Iterator[dict]:
    """Yield records from the per-client JSONL files; --follow tails."""
    positions: dict[str, int] = {}
    while True:
        pattern = os.path.join(directory, f"{client}.jsonl" if client else "*.jsonl")
        for path in sorted(glob.glob(pattern)):
            try:
                if os.path.getsize(path) < positions.get(path, 0):
                    # file truncated/rotated under us: restart from the top
                    # instead of seeking past EOF forever
                    positions[path] = 0
                with open(path) as f:
                    f.seek(positions.get(path, 0))
                    # readline (not iteration): f.tell() is illegal inside a
                    # text-file line iterator, and the offset is how --follow
                    # resumes without re-reading
                    while True:
                        line = f.readline()
                        if not line or not line.endswith("\n"):
                            break  # EOF or partial write; re-read next pass
                        positions[path] = f.tell()
                        try:
                            record = json.loads(line)
                        except json.JSONDecodeError:
                            continue  # torn line: skip, keep the stream alive
                        record["client"] = os.path.splitext(os.path.basename(path))[0]
                        yield record
            except OSError:
                continue
        if not follow:
            return
        time.sleep(0.5)


def _iter_kafka(bootstrap: str, client: str, follow: bool) -> Iterator[dict]:
    from kafka import KafkaConsumer  # gated: not in the base image

    consumer = KafkaConsumer(
        client,
        bootstrap_servers=bootstrap,
        auto_offset_reset="earliest",
        consumer_timeout_ms=(1 << 31) if follow else 5000,
        value_deserializer=lambda b: json.loads(b.decode()),
    )
    for msg in consumer:
        record = dict(msg.value)
        record["client"] = client
        yield record


def iter_records(url: str, client: str | None, follow: bool) -> Iterator[dict]:
    if url.startswith("file://"):
        return _iter_jsonl(url[len("file://") :], client, follow)
    if url.startswith("kafka://"):
        if not client:
            raise SystemExit("kafka:// needs --client (topic == client id)")
        return _iter_kafka(url[len("kafka://") :], client, follow)
    raise SystemExit(f"unsupported audit url: {url} (file:// or kafka://)")


def _summarize(record: dict) -> str:
    req = record.get("request") or {}
    resp = record.get("response") or {}
    meta = resp.get("meta") or {}
    shape = ""
    data = req.get("data") or {}
    if "ndarray" in data:
        arr = data["ndarray"]
        rows = len(arr) if isinstance(arr, list) else "?"
        shape = f" rows={rows}"
    routing = meta.get("routing") or {}
    return (
        f"{time.strftime('%H:%M:%S', time.localtime(record.get('ts', 0)))} "
        f"client={record.get('client')} puid={meta.get('puid', '')}{shape}"
        + (f" routing={routing}" if routing else "")
    )


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("url", help="file:///audit/dir or kafka://host:port")
    p.add_argument("--client", default=None, help="client id (kafka topic)")
    p.add_argument("--follow", action="store_true", help="tail new records")
    p.add_argument("--json", action="store_true", dest="as_json")
    args = p.parse_args()
    try:
        for record in iter_records(args.url, args.client, args.follow):
            print(json.dumps(record) if args.as_json else _summarize(record))
            sys.stdout.flush()
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
