"""The port's packages export what tpu_vo's do: the top-level package and
every subpackage of tpu_vo that defines __all__ have the same __all__ in
tpu_vo_torch, and each of its names resolves there; tpu_vo_torch.features,
like tpu_vo.features, imports none of its modules."""

import importlib
import os
import pkgutil
import subprocess
import sys

import pytest

import tpu_vo

PACKAGES = ["", "matching", "pipeline", "image", "models", "estimation", "geometry", "io", "viz",
            "parallel"]


def _dotted(root: str, pkg: str) -> str:
    return root + ("." + pkg if pkg else "")


def test_the_list_is_every_tpu_vo_package_with_all():
    root = os.path.dirname(tpu_vo.__file__)
    with_all = [""] if "__all__" in vars(tpu_vo) else []
    for m in pkgutil.iter_modules([root]):
        if m.ispkg:
            with open(os.path.join(root, m.name, "__init__.py")) as f:
                if "__all__" in f.read():
                    with_all.append(m.name)
    assert sorted(with_all) == sorted(PACKAGES)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_exports_equal_tpu_vo(pkg):
    ref = importlib.import_module(_dotted("tpu_vo", pkg))
    port = importlib.import_module(_dotted("tpu_vo_torch", pkg))
    assert getattr(port, "__all__", None) == ref.__all__
    missing = [name for name in ref.__all__ if not hasattr(port, name)]
    assert not missing, missing
    star = {}
    exec(f"from {port.__name__} import *", star)
    assert set(ref.__all__) <= set(star)


def test_features_package_stays_lazy():
    code = ("import sys, tpu_vo_torch.features; "
            "print(sorted(m for m in sys.modules if m.startswith('tpu_vo_torch.features.')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
