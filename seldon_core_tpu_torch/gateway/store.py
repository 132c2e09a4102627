"""Deployment registry for the gateway.

Port of ``seldon_core_tpu/gateway/store.py`` over the port's spec.

Parity: reference api-frontend DeploymentStore.java (oauth_key ->
DeploymentSpec ConcurrentHashMap :37, deploymentAdded registers the OAuth
client :63-71) + DeploymentsHandler/Listener fan-out (C14). The reference
fills this from a 5-second CRD watch; here the operator (or local API) calls
add/remove directly — same listener contract, no polling.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from seldon_core_tpu_torch.graph.spec import DeploymentSpec

Listener = Callable[[str, Optional[DeploymentSpec]], None]  # (event, spec)


class DeploymentStore:
    def __init__(self, oauth=None):
        self._by_key: dict[str, DeploymentSpec] = {}
        self._by_name: dict[str, DeploymentSpec] = {}
        self._lock = threading.Lock()
        self._listeners: list[Listener] = []
        self.oauth = oauth

    def add_listener(self, fn: Listener) -> None:
        self._listeners.append(fn)

    def _notify(self, event: str, spec: DeploymentSpec | None) -> None:
        for fn in self._listeners:
            fn(event, spec)

    def deployment_added(self, spec: DeploymentSpec) -> None:
        stale_key = ""
        with self._lock:
            old = self._by_name.get(spec.name)
            if old is not None and old.oauth_key and old.oauth_key != spec.oauth_key:
                # credential rotation: the retired key must stop routing AND
                # stop minting tokens
                self._by_key.pop(old.oauth_key, None)
                stale_key = old.oauth_key
            if spec.oauth_key:
                self._by_key[spec.oauth_key] = spec
            self._by_name[spec.name] = spec
        if self.oauth is not None and stale_key:
            self.oauth.remove_client(stale_key)
        # register the deployment's OAuth client, exactly
        # DeploymentStore.java:63-71
        if self.oauth is not None and spec.oauth_key:
            self.oauth.add_client(spec.oauth_key, spec.oauth_secret)
        self._notify("added", spec)

    def deployment_updated(self, spec: DeploymentSpec) -> None:
        self.deployment_added(spec)

    def deployment_removed(self, spec_or_name) -> None:
        name = getattr(spec_or_name, "name", spec_or_name)
        with self._lock:
            spec = self._by_name.pop(name, None)
            if spec is not None and spec.oauth_key:
                self._by_key.pop(spec.oauth_key, None)
        if spec is not None and self.oauth is not None and spec.oauth_key:
            self.oauth.remove_client(spec.oauth_key)
        self._notify("removed", spec)

    def by_principal(self, principal: str) -> DeploymentSpec | None:
        """OAuth client-id == deployment oauth_key (the reference's routing
        key: PredictionService.java:42-46)."""
        with self._lock:
            return self._by_key.get(principal)

    def by_name(self, name: str) -> DeploymentSpec | None:
        with self._lock:
            return self._by_name.get(name)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._by_name)
