"""The standalone microservice: serve one user model class on its own,
and the loader that imports it.

Port of ``seldon_core_tpu/serving/microservice.py`` (C18, reference
wrappers/python/microservice.py):

    python -m seldon_core_tpu_torch.serving.microservice <UserClass> [REST|GRPC|BOTH] \
        --service-type MODEL --model-dir DIR [--port N] [--grpc-port 5001] [--persistence]

imports module ``<UserClass>`` from ``--model-dir`` and instantiates the
class of the same name with the typed parameters of the
PREDICTIVE_UNIT_PARAMETERS env JSON as kwargs (``load_user_object``,
``parse_parameters``), wraps it as a one-unit graph of the service type
(``build_single_unit_predictor``: MODEL, ROUTER, TRANSFORMER,
OUTPUT_TRANSFORMER, COMBINER, or OUTLIER_DETECTOR, which tags
``meta.tags.outlierScore``), and serves it. ``REST`` (the default)
serves the port's fast ingress at ``--port`` (default
PREDICTIVE_UNIT_SERVICE_PORT, else 5000): the reference's internal API
that an engine's ``RemoteUnit`` calls (``/predict``, ``/route``,
``/send-feedback``, ``/transform-input``, ``/transform-output``,
``/aggregate``) and the external ``/api/v0.1/predictions`` and
``/api/v0.1/feedback``. ``GRPC`` serves the reference's gRPC services at
``--grpc-port`` (default 5001; ``serving/grpc_server.py``:
``Model.Predict``, ``Router.Route`` and the rest) and no REST port;
``BOTH`` serves both. A port of 0 binds a free one (the JAX CLI takes a
gRPC port of 0 as off); the "serving" line names the ports bound.
``--persistence`` restores the user object's state at boot and snapshots
it every minute and at shutdown through
``persistence/state.py::StatePersister`` to PERSISTENCE_STORE (default
``file://./.seldon_state``).

The loader (``load_user_object``, ``_import_user_module``,
``_dir_import_context``, ``_dir_key_for``): each model directory is
imported in isolation, its modules keyed per directory in
``sys.modules``, so two deployments whose modules share a name load their
own code, and an edited file is read again on the next load.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import importlib
import json
import logging
import os
import sys

from seldon_core_tpu_torch.graph.spec import PredictiveUnit, PredictiveUnitType, PredictorSpec
from seldon_core_tpu_torch.utils.env import (
    PERSISTENCE_STORE,
    PREDICTIVE_UNIT_ID,
    PREDICTIVE_UNIT_PARAMETERS,
    PREDICTIVE_UNIT_SERVICE_PORT,
    SELDON_DEPLOYMENT_ID,
)

log = logging.getLogger(__name__)

SERVICE_TYPES = {
    "MODEL": PredictiveUnitType.MODEL,
    "ROUTER": PredictiveUnitType.ROUTER,
    "TRANSFORMER": PredictiveUnitType.TRANSFORMER,
    "OUTPUT_TRANSFORMER": PredictiveUnitType.OUTPUT_TRANSFORMER,
    "COMBINER": PredictiveUnitType.COMBINER,
    # the reference's fourth flavour (microservice.py:140,162): serves
    # /transform-input, calls the user's score(), tags meta.tags.outlierScore
    "OUTLIER_DETECTOR": PredictiveUnitType.TRANSFORMER,
}
APIS = ("REST", "GRPC", "BOTH")


def parse_parameters(raw: str | None) -> dict:
    """PREDICTIVE_UNIT_PARAMETERS: [{"name":..,"value":..,"type":..}] with
    typed coercion (reference microservice.py:119-133)."""
    if not raw:
        return {}
    out = {}
    for p in json.loads(raw):
        value, ptype = p.get("value"), p.get("type", "STRING")
        if ptype == "INT":
            value = int(value)
        elif ptype in ("FLOAT", "DOUBLE"):
            value = float(value)
        elif ptype == "BOOL":
            value = str(value).lower() in ("1", "true", "yes")
        out[p["name"]] = value
    return out

_USER_PREFIX = "_seldon_user_"


class _ModelDirFinder:
    """Process-global meta-path finder for per-dir module keys.

    Re-keyed dir-local modules live in sys.modules as
    ``_seldon_user_<dirkey>_<name>``; this finder makes those names
    IMPORTABLE, not just cached — which is what pickle needs: user state
    holding a sibling-class instance pickles the class as
    ``(module, qualname)``, and unpickling __import__s that module. The
    dir_key is a content address (sha1 of abs_dir), so a fresh process
    that re-applies the same CR re-registers the same key and restores
    state persisted by the previous process (C19 restore-on-boot)."""

    registry: dict[str, str] = {}  # dir_key -> abs_dir

    def find_spec(self, fullname, path=None, target=None):
        if not fullname.startswith(_USER_PREFIX):
            return None
        rest = fullname[len(_USER_PREFIX) :]
        dir_key, sep, mod = rest.partition("_")
        abs_dir = self.registry.get(dir_key)
        if not abs_dir or not sep or not mod:
            return None
        import importlib.util

        parts = mod.split(".")
        flat = os.path.join(abs_dir, *parts) + ".py"
        if os.path.exists(flat):
            return importlib.util.spec_from_file_location(fullname, flat)
        pkg_init = os.path.join(abs_dir, *parts, "__init__.py")
        if os.path.exists(pkg_init):
            return importlib.util.spec_from_file_location(
                fullname,
                pkg_init,
                submodule_search_locations=[os.path.join(abs_dir, *parts)],
            )
        return None


_finder = _ModelDirFinder()
_active_dirs: set[str] = set()  # dirs with an open _dir_import_context


def _dir_key_for(abs_dir: str) -> str:
    import hashlib

    return hashlib.sha1(abs_dir.encode()).hexdigest()[:12]


def _rekey_module(mod_name: str, module, dir_key: str) -> None:
    """Move a dir-local module from its bare sys.modules name to the
    per-dir key, updating the module's own identity (__name__/__spec__)
    and the __module__ of its defs — including classes NESTED inside other
    classes (pickle references them by module + qualname too) — so pickle
    emits the importable per-dir name instead of the popped bare one."""
    import inspect

    new_name = f"{_USER_PREFIX}{dir_key}_{mod_name}"

    def _rewrite(obj, seen: set) -> None:
        if id(obj) in seen:
            return
        seen.add(id(obj))
        if getattr(obj, "__module__", None) != mod_name:
            return  # foreign object — nothing of ours can be nested in it
        try:
            obj.__module__ = new_name
        except (AttributeError, TypeError):
            return
        if inspect.isclass(obj):
            for member in list(vars(obj).values()):
                if inspect.isclass(member) or inspect.isfunction(member):
                    _rewrite(member, seen)

    seen: set = set()
    for obj in list(vars(module).values()):
        _rewrite(obj, seen)
    try:
        module.__name__ = new_name
        if getattr(module, "__spec__", None) is not None:
            module.__spec__.name = new_name
    except (AttributeError, TypeError):
        pass
    sys.modules[new_name] = sys.modules.pop(mod_name)


@contextlib.contextmanager
def _dir_import_context(abs_dir: str, dir_key: str):
    """Scoped sibling isolation for one model dir.

    Inside the context, abs_dir is on sys.path so the entry module (and its
    __init__) can import dir-local code. On exit the dir leaves sys.path
    and every module that was loaded FROM it — flat sibling .py, sibling
    package, or a package-form entry module itself — is re-keyed from its
    bare sys.modules name to a per-dir name: loaded objects keep their
    direct references, the per-dir names stay importable through
    _ModelDirFinder (pickle/persistence), and the next CR's same-named
    module resolves fresh from ITS dir instead of silently sharing this
    one's code. Reentrant for the same dir (inner context is a no-op).
    Residual limitation: a dir-local module imported lazily at request
    time (inside predict()) by its BARE name raises ImportError instead
    of reusing another dir's module — do runtime imports at the entry
    module's top level or in __init__.
    """
    if _finder not in sys.meta_path:
        sys.meta_path.append(_finder)
    _ModelDirFinder.registry[dir_key] = abs_dir
    if abs_dir in _active_dirs:
        # nested context for the same dir: the outermost owns the re-key
        yield
        return
    _active_dirs.add(abs_dir)
    path_added = abs_dir not in sys.path
    if path_added:
        sys.path.insert(0, abs_dir)
    before = set(sys.modules)
    try:
        yield
    finally:
        _active_dirs.discard(abs_dir)
        if path_added and abs_dir in sys.path:
            sys.path.remove(abs_dir)
        for mod_name in set(sys.modules) - before:
            if mod_name.startswith(_USER_PREFIX):
                continue  # already per-dir keyed (entry module)
            m = sys.modules.get(mod_name)
            if m is not None and _module_from_dir(m, abs_dir):
                _rekey_module(mod_name, m, dir_key)


def _module_from_dir(mod, abs_dir: str) -> bool:
    mod_file = getattr(mod, "__file__", None) or ""
    if mod_file and os.path.abspath(mod_file).startswith(abs_dir + os.sep):
        return True
    # namespace/regular packages: __path__ entries instead of __file__.
    # Some modules carry exotic __path__ objects (torch.classes) — treat
    # anything not iterable into strings as not-from-dir.
    try:
        entries = [os.fspath(p) for p in getattr(mod, "__path__", ()) or ()]
    except TypeError:
        return False
    return any(os.path.abspath(p).startswith(abs_dir + os.sep) for p in entries)


def _import_user_module(name: str, model_dir: str):
    """Load ``<model_dir>/<name>.py`` under a key unique to that path.

    A long-lived multi-CR platform process cannot use the bare module name:
    ``importlib.import_module`` caches by name, so two CRs whose modules are
    both called ``Model`` (different dirs) would silently share the first
    dir's code, and a re-applied CR would never pick up an edited file.
    Loading by file location under a per-path key gives each dir its own
    module and re-executes the file on every build; _dir_import_context
    gives its siblings the same isolation.
    """
    import importlib.util

    abs_dir = os.path.abspath(model_dir)
    dir_key = _dir_key_for(abs_dir)
    path = os.path.join(abs_dir, name + ".py")
    with _dir_import_context(abs_dir, dir_key):
        if os.path.exists(path):
            key = f"{_USER_PREFIX}{dir_key}_{name}"
            spec = importlib.util.spec_from_file_location(key, path)
            module = importlib.util.module_from_spec(spec)
            sys.modules[key] = module
            spec.loader.exec_module(module)
            return module
        # package-form entry (<name>/__init__.py) or an installed module:
        # import by bare name; if it came from this dir the context's
        # re-key moves it out of the bare-name cache like any sibling, so
        # another dir's same-named entry resolves fresh (installed modules
        # stay cached — they're dir-independent)
        return importlib.import_module(name)


def load_user_object(name: str, model_dir: str | None = None, parameters: dict | None = None):
    """Import module ``name``, instantiate class ``name`` with the typed
    parameters as kwargs — the reference contract (interface_name == module
    name == class name, microservice.py:136-140). Instantiation runs INSIDE
    the dir-import context (which is reentrant, so the nested
    _import_user_module context is a no-op): user __init__s lazily import
    dir-local helpers (e.g. a train-on-first-boot module), and those get
    the same per-dir isolation as top-level imports."""
    if model_dir:
        abs_dir = os.path.abspath(model_dir)
        with _dir_import_context(abs_dir, _dir_key_for(abs_dir)):
            module = _import_user_module(name, model_dir)
            cls = getattr(module, name)
            return cls(**(parameters or {}))
    module = importlib.import_module(name)
    cls = getattr(module, name)
    return cls(**(parameters or {}))


def build_single_unit_predictor(name: str, service_type: str) -> PredictorSpec:
    """A one-unit graph of the service type. Children stay empty even for
    a router or a combiner: the microservice serves the unit's own API, and
    the graph around it lives in whichever engine calls it."""
    unit_type = SERVICE_TYPES[service_type]
    return PredictorSpec(
        name=name, graph=PredictiveUnit.from_dict({"name": name, "type": unit_type.value, "children": []})
    )


class _UserStateAdapter:
    """A user object persists whole (the reference pickles the object): its
    ``__dict__`` through the persister's getstate/setstate contract."""

    def __init__(self, name: str, user_object):
        self.name = name
        self._user = user_object

    def __getstate__(self):
        return self._user.__dict__

    def __setstate__(self, state):
        self._user.__dict__.update(state)


class ServedMicroservice(tuple):
    """What ``serve_microservice`` returns: it unpacks as (server, service,
    persister), where ``server`` is the REST ingress (None when REST is
    off), and holds the gRPC server in ``grpc_server`` (None without
    one)."""

    def __new__(cls, server, service, persister, grpc_server=None):
        self = super().__new__(cls, (server, service, persister))
        self.grpc_server = grpc_server
        return self


async def serve_microservice(
    user_object,
    name: str,
    service_type: str = "MODEL",
    *,
    host: str = "0.0.0.0",
    http_port: int | None = None,
    grpc_port: int | None = None,
    enable_rest: bool = True,
    persistence_url: str = "",
    persistence_period_s: float = 60.0,
    decode_npy: bool = True,
) -> ServedMicroservice:
    """Serve one user object over REST on the fast ingress (unless
    ``enable_rest`` is off) and over gRPC when ``grpc_port`` is given (0
    binds a free port: ``grpc_server.bound_port``). Close ``server``, stop
    ``grpc_server``, then ``persister.stop()`` when there is one."""
    from seldon_core_tpu_torch.engine.executor import build_executor
    from seldon_core_tpu_torch.engine.units import OutlierDetectorUnit, PythonClassUnit
    from seldon_core_tpu_torch.metrics import get_metrics
    from seldon_core_tpu_torch.serving.fast_http import engine_routes, start_fast_server
    from seldon_core_tpu_torch.serving.service import PredictionService

    predictor = build_single_unit_predictor(name, service_type)
    unit_cls = OutlierDetectorUnit if service_type == "OUTLIER_DETECTOR" else PythonClassUnit
    executor = build_executor(predictor, context={"units": {name: unit_cls(predictor.graph, user_object)}})
    service = PredictionService(executor, deployment_name=name, metrics=get_metrics(True), decode_npy=decode_npy)

    persister = None
    if persistence_url:
        from seldon_core_tpu_torch.persistence.state import StatePersister, make_state_store

        store = make_state_store(persistence_url)
        if store is not None:
            deployment_id = os.environ.get(SELDON_DEPLOYMENT_ID, name)
            unit_id = os.environ.get(PREDICTIVE_UNIT_ID, name)
            # the raw user object's learned state, never the unit wrapping it
            persister = StatePersister(store, deployment_id, period_s=persistence_period_s)
            if persister.attach([_UserStateAdapter(unit_id, user_object)]):
                log.info("restored persisted state for %s", unit_id)
            persister.start()

    server = None
    if enable_rest:
        port = http_port if http_port is not None else int(os.environ.get(PREDICTIVE_UNIT_SERVICE_PORT, "5000"))
        server = await start_fast_server(engine_routes(service, {"paused": False}), host, port)
        log.info("microservice %s (%s) REST on %s:%s", name, service_type, host, port)
    grpc_server = None
    if grpc_port is not None:
        from seldon_core_tpu_torch.serving.grpc_server import start_grpc_server

        grpc_server = await start_grpc_server(service, host, grpc_port)
        log.info("microservice %s (%s) gRPC on %s:%s", name, service_type, host, grpc_server.bound_port)
    return ServedMicroservice(server, service, persister, grpc_server)


async def _amain(args) -> None:
    import signal

    parameters = parse_parameters(os.environ.get(PREDICTIVE_UNIT_PARAMETERS))
    user_object = load_user_object(args.interface_name, args.model_dir, parameters)
    persistence_url = os.environ.get(PERSISTENCE_STORE, "file://./.seldon_state") if args.persistence else ""
    served = await serve_microservice(
        user_object,
        args.interface_name,
        args.service_type,
        http_port=args.port,
        grpc_port=args.grpc_port if args.api in ("GRPC", "BOTH") else None,
        enable_rest=args.api in ("REST", "BOTH"),
        persistence_url=persistence_url,
        decode_npy=not args.no_decode_npy,
    )
    server, _, persister = served
    grpc_server = served.grpc_server
    listening = []
    if server is not None:
        listening.append(f"REST :{server.sockets[0].getsockname()[1]}")
    if grpc_server is not None:
        listening.append(f"gRPC :{grpc_server.bound_port}")
    print(
        f"seldon-core-tpu-torch microservice {args.interface_name} ({args.service_type}) serving "
        + " ".join(listening),
        flush=True,
    )
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    if grpc_server is not None:
        await grpc_server.stop(5)
    if server is not None:
        server.close()
        await server.wait_closed()
    if persister is not None:
        persister.stop()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="serve one user model class standalone (REST and/or gRPC)")
    p.add_argument("interface_name", help="module and class name of the user model")
    p.add_argument("api", nargs="?", default="REST", choices=APIS)
    p.add_argument("--service-type", default="MODEL", choices=sorted(SERVICE_TYPES))
    p.add_argument("--model-dir", default=".")
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--grpc-port", type=int, default=5001)
    p.add_argument("--persistence", action="store_true")
    p.add_argument(
        "--no-decode-npy",
        action="store_true",
        help="never sniff binData for npy: opaque passthrough for bytes-contract models",
    )
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    asyncio.run(_amain(args))


if __name__ == "__main__":
    main()
