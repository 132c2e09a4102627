"""OAuth2 provider for the ingress gateway.

Port of ``seldon_core_tpu/gateway/oauth.py``, unchanged but for this
docstring: ``redis://`` stays gated on its client library (absent, the
store is in-memory), as in the JAX package.

Parity: reference api-frontend Spring OAuth2 stack (C15) —
AuthorizationServerConfiguration.java (RedisTokenStore, client_credentials +
password grants), InMemoryClientDetailsService.java:34-44 (12 h token
lifetime, one client per deployment keyed by oauth_key). Token persistence is
pluggable: in-memory for single-process, file-backed so gateway restarts keep
sessions (the reference uses Redis for exactly that), redis if available.
"""

from __future__ import annotations

import json
import os
import secrets
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

TOKEN_TTL_S = 12 * 3600  # reference: 12h (InMemoryClientDetailsService.java:41-43)


@dataclass
class TokenRecord:
    client_id: str
    expires_at: float


class InMemoryTokenStore:
    """Token -> principal map with expiry (RedisTokenStore stand-in)."""

    def __init__(self):
        self._tokens: dict[str, TokenRecord] = {}
        self._lock = threading.Lock()

    def put(self, token: str, record: TokenRecord) -> None:
        with self._lock:
            self._tokens[token] = record

    def get(self, token: str) -> Optional[TokenRecord]:
        with self._lock:
            rec = self._tokens.get(token)
            if rec is None:
                return None
            if rec.expires_at < time.time():
                del self._tokens[token]
                return None
            return rec

    def revoke_client(self, client_id: str) -> None:
        with self._lock:
            self._tokens = {
                t: r for t, r in self._tokens.items() if r.client_id != client_id
            }


class FileTokenStore(InMemoryTokenStore):
    """Durable token store: gateway restarts don't invalidate sessions — the
    property the reference gets from Redis (AuthorizationServerConfiguration
    .java:64-67). Append-only JSONL (token grants + revoke tombstones) so a
    token issuance is O(1) I/O, not a whole-file rewrite; the log is
    compacted to live tokens on load."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        if os.path.exists(path):
            try:
                with open(path) as f:
                    for line in f:
                        rec = json.loads(line)
                        if "revoke_client" in rec:
                            cid = rec["revoke_client"]
                            self._tokens = {
                                t: r
                                for t, r in self._tokens.items()
                                if r.client_id != cid
                            }
                        elif rec.get("expires_at", 0) > time.time():
                            self._tokens[rec["token"]] = TokenRecord(
                                rec["client_id"], rec["expires_at"]
                            )
            except Exception:  # noqa: BLE001 - corrupt store: start clean
                self._tokens = {}
            self._compact()

    def _compact(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            for t, r in self._tokens.items():
                f.write(
                    json.dumps(
                        {"token": t, "client_id": r.client_id, "expires_at": r.expires_at}
                    )
                    + "\n"
                )
        os.replace(tmp, self.path)

    def _append(self, rec: dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def put(self, token: str, record: TokenRecord) -> None:
        with self._lock:
            self._tokens[token] = record
            self._append(
                {
                    "token": token,
                    "client_id": record.client_id,
                    "expires_at": record.expires_at,
                }
            )

    def revoke_client(self, client_id: str) -> None:
        with self._lock:
            self._tokens = {
                t: r for t, r in self._tokens.items() if r.client_id != client_id
            }
            self._append({"revoke_client": client_id})


def make_token_store(url: str | None = None):
    """'' | None -> in-memory; file://<path> -> durable file;
    redis://host[:port] -> redis when the client lib is importable."""
    if not url:
        return InMemoryTokenStore()
    if url.startswith("file://"):
        return FileTokenStore(url[len("file://") :])
    if url.startswith("redis://"):
        try:
            return RedisTokenStore(url)
        except ImportError:
            return InMemoryTokenStore()
    raise ValueError(f"unknown token store url: {url}")


class RedisTokenStore(InMemoryTokenStore):
    """Redis-backed store, key per token with native TTL expiry."""

    def __init__(self, url: str):
        import redis  # gated: not in the base image

        super().__init__()
        self._r = redis.Redis.from_url(url)

    def put(self, token: str, record: TokenRecord) -> None:
        ttl = max(1, int(record.expires_at - time.time()))
        self._r.setex(f"oauth:{token}", ttl, record.client_id)

    def get(self, token: str) -> Optional[TokenRecord]:
        cid = self._r.get(f"oauth:{token}")
        if cid is None:
            return None
        return TokenRecord(cid.decode(), time.time() + 1)

    def revoke_client(self, client_id: str) -> None:
        for key in self._r.scan_iter("oauth:*"):
            if self._r.get(key) == client_id.encode():
                self._r.delete(key)


@dataclass
class ClientDetails:
    client_id: str
    client_secret: str
    scopes: tuple[str, ...] = ("read", "write")


class OAuthProvider:
    """client_credentials (and password-grant, accepted but identical) token
    issuance + validation. One registered client per deployment, exactly the
    reference's DeploymentStore.deploymentAdded -> addClient flow."""

    def __init__(self, token_store=None):
        self.tokens = token_store or InMemoryTokenStore()
        self._clients: dict[str, ClientDetails] = {}
        self._lock = threading.Lock()

    # ---- client registry (driven by the deployment store)
    def add_client(self, client_id: str, client_secret: str) -> None:
        with self._lock:
            self._clients[client_id] = ClientDetails(client_id, client_secret)

    def remove_client(self, client_id: str) -> None:
        with self._lock:
            self._clients.pop(client_id, None)
        self.tokens.revoke_client(client_id)

    def has_client(self, client_id: str) -> bool:
        with self._lock:
            return client_id in self._clients

    # ---- grants
    def issue_token(self, client_id: str, client_secret: str) -> dict:
        """Returns the standard token response or raises PermissionError."""
        with self._lock:
            details = self._clients.get(client_id)
        if details is None or not secrets.compare_digest(
            details.client_secret, client_secret
        ):
            raise PermissionError("invalid client credentials")
        token = secrets.token_urlsafe(32)
        self.tokens.put(token, TokenRecord(client_id, time.time() + TOKEN_TTL_S))
        return {
            "access_token": token,
            "token_type": "bearer",
            "expires_in": TOKEN_TTL_S,
            "scope": "read write",
        }

    def principal(self, token: str) -> Optional[str]:
        rec = self.tokens.get(token)
        return rec.client_id if rec else None
