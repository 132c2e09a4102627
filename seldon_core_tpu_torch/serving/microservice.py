"""Loading a user's model class into the serving process.

Port of the loader of ``seldon_core_tpu/serving/microservice.py``
(``load_user_object``, ``_import_user_module``, ``_dir_import_context``,
``_dir_key_for``): a PYTHON_CLASS unit names a module, and optionally the
directory it lives in; the module is imported, the class of the same name
instantiated with the unit's remaining parameters as kwargs (the
reference's wrappers/python contract: module name == class name).

Each model directory is imported in isolation: its modules are keyed per
directory in ``sys.modules``, so two deployments whose modules share a
name load their own code, and an edited file is read again on the next
load. The standalone microservice CLI of the JAX module is not part of the
port yet.
"""

from __future__ import annotations

import contextlib
import importlib
import os
import sys

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

