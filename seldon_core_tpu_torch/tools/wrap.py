"""Model packaging CLI: wrap a user model directory into a deployable bundle.

Port of ``seldon_core_tpu/tools/wrap.py``. Parity: reference
wrappers/python/wrap_model.py — copies the model dir and renders
Dockerfile/build_image.sh/push_image.sh templates so the model becomes a
runnable microservice image. Here the bundle targets the port's serving
runtime instead of the Py2 Flask wrapper:

    <out>/
      Dockerfile          serve the class via the seldon_core_tpu_torch microservice
      build_image.sh      docker build tag $repo/$name:$version
      push_image.sh       docker push
      deployment.json     ready-to-apply SeldonDeployment CR for the model

CLI (argument order mirrors wrap_model.py):
    python -m seldon_core_tpu_torch.tools.wrap MODEL_DIR MODEL_NAME VERSION REPO \
        [--grpc] [--persistence] [--base-image IMAGE] [--force]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import stat

DOCKERFILE_TMPL = """FROM {base_image}
COPY . /microservice
WORKDIR /microservice
RUN test -f requirements.txt && pip install -r requirements.txt || true
EXPOSE 5000
ENV PREDICTIVE_UNIT_SERVICE_PORT 5000
CMD ["python", "-m", "seldon_core_tpu_torch.serving.microservice", "{name}", "{api}", "--service-type", "{service_type}", "--model-dir", "/microservice"{persistence_arg}]
"""

BUILD_SH_TMPL = """#!/bin/sh
set -e
docker build --force-rm=true -t {repo}/{name}:{version} .
"""

PUSH_SH_TMPL = """#!/bin/sh
set -e
docker push {repo}/{name}:{version}
"""


def deployment_cr(name: str, image: str, service_type: str = "MODEL") -> dict:
    """A minimal SeldonDeployment CR for the wrapped image (the reference
    docs show the same hand-written JSON, e.g. sklearn_iris_deployment.json)."""
    return {
        "apiVersion": "machinelearning.seldon.io/v1alpha1",
        "kind": "SeldonDeployment",
        "metadata": {"name": name},
        "spec": {
            "name": f"{name}-deployment",
            "oauth_key": "oauth-key",
            "oauth_secret": "oauth-secret",
            "predictors": [
                {
                    "name": f"{name}-predictor",
                    "replicas": 1,
                    "componentSpec": {
                        "containers": [{"name": name, "image": image}]
                    },
                    "graph": {
                        "name": name,
                        "type": service_type,
                        "endpoint": {"type": "REST"},
                        "children": [],
                    },
                }
            ],
        },
    }


def wrap_model(
    model_dir: str,
    name: str,
    version: str,
    repo: str,
    *,
    out_dir: str | None = None,
    api: str = "REST",
    service_type: str = "MODEL",
    base_image: str = "python:3.12-slim",
    persistence: bool = False,
    force: bool = False,
) -> str:
    """Build the bundle directory; returns its path."""
    out = out_dir or os.path.join(model_dir, "build")
    if os.path.exists(out):
        if not force:
            raise FileExistsError(f"{out} exists; use --force to overwrite")
        shutil.rmtree(out)
    shutil.copytree(model_dir, out, ignore=shutil.ignore_patterns("build"))

    image = f"{repo}/{name}:{version}"
    files = {
        "Dockerfile": DOCKERFILE_TMPL.format(
            base_image=base_image,
            name=name,
            api=api,
            service_type=service_type,
            persistence_arg=', "--persistence"' if persistence else "",
        ),
        "build_image.sh": BUILD_SH_TMPL.format(repo=repo, name=name, version=version),
        "push_image.sh": PUSH_SH_TMPL.format(repo=repo, name=name, version=version),
        "deployment.json": json.dumps(
            deployment_cr(name, image, service_type), indent=2
        ),
    }
    for fname, content in files.items():
        path = os.path.join(out, fname)
        with open(path, "w") as f:
            f.write(content)
        if fname.endswith(".sh"):
            os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)
    return out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("model_dir")
    p.add_argument("name")
    p.add_argument("version")
    p.add_argument("repo")
    p.add_argument("--out-dir", default=None)
    p.add_argument("--grpc", action="store_true")
    p.add_argument("--service-type", default="MODEL")
    p.add_argument("--base-image", default="python:3.12-slim")
    p.add_argument("--persistence", action="store_true")
    p.add_argument("-f", "--force", action="store_true")
    args = p.parse_args()
    out = wrap_model(
        args.model_dir,
        args.name,
        args.version,
        args.repo,
        out_dir=args.out_dir,
        api="GRPC" if args.grpc else "REST",
        service_type=args.service_type,
        base_image=args.base_image,
        persistence=args.persistence,
        force=args.force,
    )
    print(out)


if __name__ == "__main__":
    main()
