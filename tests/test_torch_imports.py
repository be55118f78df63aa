"""The port stands on its own: it imports neither jax nor the JAX package."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKG = os.path.join(REPO, "vf_fem_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "vf_fem_tpu")


def _sources():
    # the card's smoke script and kernel comparison stand on the port alone
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "kernel_turns.py")
    for root, dirs, files in os.walk(PKG):
        dirs[:] = sorted(d for d in dirs if d != "_build")  # build outputs
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize(
    "path", list(_sources()), ids=lambda p: os.path.relpath(p, REPO)
)
def test_no_jax_import_in_source(path):
    bad = set(_imported_roots(path)) & set(FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


def test_import_leaves_jax_unloaded():
    # modules the import adds, in a fresh interpreter (whatever a site hook
    # may have loaded before it)
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import vf_fem_tpu_torch, vf_fem_tpu_torch.load, vf_fem_tpu_torch.forward\n"
        "import vf_fem_tpu_torch.adjoint, vf_fem_tpu_torch.functional\n"
        "import vf_fem_tpu_torch.stepfunctional, vf_fem_tpu_torch.misc.taylor\n"
        "import vf_fem_tpu_torch.parameters, vf_fem_tpu_torch.static\n"
        "import vf_fem_tpu_torch.models.acoustic, vf_fem_tpu_torch.models.fsai\n"
        "import vf_fem_tpu_torch.functional.acoustic, vf_fem_tpu_torch.mesh.m5\n"
        "import vf_fem_tpu_torch.mesh.writers, vf_fem_tpu_torch.mesh.triangulate\n"
        "import vf_fem_tpu_torch.models.dynamical, vf_fem_tpu_torch.solvers.cbtd\n"
        "import vf_fem_tpu_torch.misc.hopf\n"
        "import vf_fem_tpu_torch.fem.forms, vf_fem_tpu_torch.fem.continuum\n"
        "import vf_fem_tpu_torch.fem.elements, vf_fem_tpu_torch.residuals.solid\n"
        "import vf_fem_tpu_torch.residuals.fluid, vf_fem_tpu_torch.mesh.interface\n"
        "import vf_fem_tpu_torch.postprocess, vf_fem_tpu_torch.postprocess.solid\n"
        "import vf_fem_tpu_torch.postprocess.fluid, vf_fem_tpu_torch.vis\n"
        "import vf_fem_tpu_torch.vis.vis, vf_fem_tpu_torch.vis.xdmfutils\n"
        "import vf_fem_tpu_torch.utils, vf_fem_tpu_torch.constants\n"
        "import vf_fem_tpu_torch.misc.signal, vf_fem_tpu_torch.mesh.dofmaps\n"
        "import vf_fem_tpu_torch.equations.newmark, vf_fem_tpu_torch.models.transient\n"
        f"bad = [m for m in set(sys.modules) - before"
        f" if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
