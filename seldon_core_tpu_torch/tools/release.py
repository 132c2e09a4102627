"""Release automation for the port (reference release.py + Jenkinsfile).

Port of ``seldon_core_tpu/tools/release.py``. The reference's release.py
rewrites the version in every pom/chart; the Jenkinsfile builds and
publishes the service images. Here one command does the equivalent for the
port's single platform image:

    python -m seldon_core_tpu_torch.tools.release 0.2.0            # set version
    python -m seldon_core_tpu_torch.tools.release 0.2.0 --tag      # + git commit + tag v0.2.0
    python -m seldon_core_tpu_torch.tools.release 0.2.0 --build    # + docker build
    python -m seldon_core_tpu_torch.tools.release 0.2.0 --push --registry ghcr.io/me

Files rewritten (the version's single sources of truth):
- seldon_core_tpu_torch/__init__.py   __version__
- pyproject.toml                      [project] version
- deploy/values.yaml                  platform.image tag, only where it names
                                      the port's image (``IMAGE_BASENAME``)

The JAX package's ``seldon_core_tpu/version.py`` is never touched, and a
values file naming the JAX package's image is left as it is. ``--build``
builds ``Dockerfile.torch``: a CUDA PyTorch base with the port copied in,
whose kernels build at their first use.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

from seldon_core_tpu_torch.utils.env import SELDON_TPU_REGISTRY

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
IMAGE_BASENAME = "seldon-core-tpu-torch/platform"
DOCKERFILE = "Dockerfile.torch"
VERSION_FILE = "seldon_core_tpu_torch/__init__.py"


def _rewrite(path: str, pattern: str, replacement: str) -> bool:
    full = os.path.join(REPO_ROOT, path)
    with open(full) as f:
        src = f.read()
    out, n = re.subn(pattern, replacement, src, count=1)
    if n:
        with open(full, "w") as f:
            f.write(out)
    return bool(n)


def set_version(version: str) -> list[str]:
    """Rewrite the version everywhere it lives; returns the changed files."""
    changed = []
    if _rewrite(
        VERSION_FILE,
        r'__version__ = "[^"]+"',
        f'__version__ = "{version}"',
    ):
        changed.append(VERSION_FILE)
    if _rewrite(
        "pyproject.toml", r'(?m)^version = "[^"]+"', f'version = "{version}"'
    ):
        changed.append("pyproject.toml")
    if _rewrite(
        "deploy/values.yaml",
        rf"(image: {re.escape(IMAGE_BASENAME)}):\S+",
        rf"\1:{version}",
    ):
        changed.append("deploy/values.yaml")
    return changed


def run(cmd: list[str]) -> None:
    print("+ " + " ".join(cmd), flush=True)
    subprocess.run(cmd, check=True, cwd=REPO_ROOT)


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("version", help="semver to release, e.g. 0.2.0")
    p.add_argument("--tag", action="store_true", help="git commit + tag v<version>")
    p.add_argument("--build", action="store_true", help=f"docker build the platform image from {DOCKERFILE}")
    p.add_argument("--push", action="store_true", help="docker push (implies --build)")
    p.add_argument(
        "--registry",
        default=os.environ.get(SELDON_TPU_REGISTRY, ""),
        help="registry prefix for --push, e.g. ghcr.io/org (env SELDON_TPU_REGISTRY)",
    )
    args = p.parse_args(argv)
    if not re.fullmatch(r"\d+\.\d+\.\d+([-.+][\w.]+)?", args.version):
        sys.exit(f"not a version: {args.version}")

    changed = set_version(args.version)
    print(f"version {args.version} -> {', '.join(changed) or 'nothing changed'}")

    if args.tag:
        if changed:
            run(["git", "add", *changed])
            run(["git", "commit", "-m", f"Release {args.version}"])
        else:
            print("version already current; tagging HEAD")
        run(["git", "tag", f"v{args.version}"])

    if args.build or args.push:
        image = f"{IMAGE_BASENAME}:{args.version}"
        if args.registry:
            image = f"{args.registry.rstrip('/')}/{image}"
        run(["docker", "build", "-f", DOCKERFILE, "-t", image, "."])
        run(["docker", "tag", image, image.rsplit(":", 1)[0] + ":latest"])
        if args.push:
            run(["docker", "push", image])
            run(["docker", "push", image.rsplit(":", 1)[0] + ":latest"])


if __name__ == "__main__":
    main()
