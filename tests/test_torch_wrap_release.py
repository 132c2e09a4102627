"""The port's packaging tools against the JAX package's.

- ``tools/wrap.py``: ``wrap_model``'s bundle is the JAX package's, file for
  file, except the module the rendered ``Dockerfile`` runs.
- ``tools/release.py``: ``set_version`` on a copy of the checkout rewrites
  the port's ``__version__`` and ``pyproject.toml``, leaves the JAX
  package's ``version.py`` byte for byte, and rewrites a values file's image
  only where it names the port's image; ``--build`` (``run`` recorded, not
  run) builds ``Dockerfile.torch`` into the port's image.
"""

from __future__ import annotations

import filecmp
import os
import shutil

import pytest

from seldon_core_tpu.tools import wrap as jax_wrap
from seldon_core_tpu_torch.tools import release, wrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_DIRS = [
    os.path.join(REPO, "seldon_core_tpu_torch", "examples", "models", "torch_mnist_cnn"),
    os.path.join(REPO, "examples", "models", "mean_classifier"),
]


@pytest.mark.parametrize("options", [
    {},
    {"api": "GRPC", "service_type": "ROUTER", "persistence": True, "base_image": "python:3.12"},
], ids=["rest", "grpc_router_persistence"])
@pytest.mark.parametrize("model_dir", MODEL_DIRS, ids=["torch_mnist_cnn", "mean_classifier"])
def test_wrap_bundle_matches_jax(tmp_path, model_dir, options):
    ours = wrap.wrap_model(model_dir, "mymodel", "0.1", "repo", out_dir=str(tmp_path / "ours"), **options)
    theirs = jax_wrap.wrap_model(model_dir, "mymodel", "0.1", "repo", out_dir=str(tmp_path / "theirs"), **options)
    cmp = filecmp.dircmp(ours, theirs)
    assert cmp.left_only == [] and cmp.right_only == [] and cmp.common_funny == []

    def walk(c):
        yield from (os.path.join(os.path.relpath(c.left, ours), f) for f in c.diff_files)
        for sub in c.subdirs.values():
            yield from walk(sub)

    assert sorted(walk(cmp)) == ["./Dockerfile"]
    with open(os.path.join(ours, "Dockerfile")) as f:
        mine = f.read()
    with open(os.path.join(theirs, "Dockerfile")) as f:
        jax = f.read()
    assert mine == jax.replace("seldon_core_tpu.serving.microservice", "seldon_core_tpu_torch.serving.microservice")
    assert '"seldon_core_tpu_torch.serving.microservice", "mymodel"' in mine
    assert os.access(os.path.join(ours, "build_image.sh"), os.X_OK)
    with pytest.raises(FileExistsError):
        wrap.wrap_model(model_dir, "mymodel", "0.1", "repo", out_dir=ours)


@pytest.fixture
def checkout(tmp_path, monkeypatch):
    """A copy of the files ``release`` rewrites, with the JAX package's
    version file beside them, as REPO_ROOT."""
    for rel in ("seldon_core_tpu_torch/__init__.py", "seldon_core_tpu/version.py", "pyproject.toml",
                "deploy/values.yaml", "Dockerfile.torch"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(os.path.join(REPO, rel), tmp_path / rel)
    monkeypatch.setattr(release, "REPO_ROOT", str(tmp_path))
    return tmp_path


def test_release_set_version_rewrites_the_port_only(checkout):
    jax_version = (checkout / "seldon_core_tpu" / "version.py").read_bytes()
    values = (checkout / "deploy" / "values.yaml").read_bytes()
    changed = release.set_version("9.9.9")
    assert changed == ["seldon_core_tpu_torch/__init__.py", "pyproject.toml"]
    assert '__version__ = "9.9.9"' in (checkout / "seldon_core_tpu_torch" / "__init__.py").read_text()
    assert 'version = "9.9.9"' in (checkout / "pyproject.toml").read_text()
    assert (checkout / "seldon_core_tpu" / "version.py").read_bytes() == jax_version
    # the values file names the JAX package's image: left alone
    assert (checkout / "deploy" / "values.yaml").read_bytes() == values


def test_release_rewrites_a_values_file_naming_the_port_image(checkout):
    path = checkout / "deploy" / "values.yaml"
    path.write_text(path.read_text().replace("seldon-core-tpu/platform:latest",
                                             f"{release.IMAGE_BASENAME}:0.1.0"))
    assert "deploy/values.yaml" in release.set_version("1.2.3")
    assert f"image: {release.IMAGE_BASENAME}:1.2.3" in path.read_text()


def test_release_build_names_the_port_dockerfile_and_image(checkout, monkeypatch):
    ran = []
    monkeypatch.setattr(release, "run", ran.append)
    release.main(["0.3.0", "--push", "--registry", "ghcr.io/me/"])
    image = f"ghcr.io/me/{release.IMAGE_BASENAME}:0.3.0"
    assert ran == [
        ["docker", "build", "-f", "Dockerfile.torch", "-t", image, "."],
        ["docker", "tag", image, image.rsplit(":", 1)[0] + ":latest"],
        ["docker", "push", image],
        ["docker", "push", image.rsplit(":", 1)[0] + ":latest"],
    ]
    assert release.IMAGE_BASENAME != "seldon-core-tpu/platform"
    with pytest.raises(SystemExit):
        release.main(["not-a-version"])


def test_dockerfile_torch_serves_the_port():
    from seldon_core_tpu_torch.tools import install

    with open(os.path.join(REPO, release.DOCKERFILE)) as f:
        text = f.read()
    lines = [ln for ln in text.splitlines() if not ln.startswith("#")]
    assert 'ENTRYPOINT ["python", "-m", "seldon_core_tpu_torch.platform"]' in lines
    assert any(ln.startswith("FROM pytorch/pytorch:") and "cuda" in ln for ln in lines)
    assert "COPY seldon_core_tpu_torch ./seldon_core_tpu_torch" in lines
    assert not any("jax" in ln or "seldon_core_tpu " in ln or "seldon_core_tpu/" in ln for ln in lines)
    # the install bundle's default image is the one release builds
    assert install.DEFAULT_VALUES["platform"]["image"] == f"{release.IMAGE_BASENAME}:latest"
