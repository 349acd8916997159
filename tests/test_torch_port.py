"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the JAX package ``repro``."""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _dirs, names in os.walk(PORT):
        out += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT)
)
def test_no_jax_or_reference_import_in_source(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_importing_every_module_loads_no_jax():
    code = (
        "import pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]), bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True,
        cwd=ROOT, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.split(" ", 1)
    assert int(count) >= 15
    assert bad.strip() == "[]"


def test_repolint_stays_clean_over_the_port():
    from repro.analysis import repolint

    violations = repolint.lint_paths([PORT], tests_dir=os.path.join(ROOT, "tests"))
    assert violations == [], "\n".join(str(v) for v in violations)


MESH_MODULES = ("sharding/__init__.py", "sharding/policy.py", "launch/mesh.py",
                "launch/specs.py", "launch/dryrun.py", "analysis/roofline.py")


@pytest.mark.parametrize("rel", MESH_MODULES)
def test_mesh_modules_are_scanned(rel):
    """The mesh half's modules are among the files the scan above reads."""
    assert os.path.join(PORT, rel) in _port_files()


def test_mesh_modules_import_without_a_process_group():
    """Importing the mesh half starts no process group and builds no mesh:
    the meshes are functions (the reference's ``launch/mesh.py`` rule)."""
    code = (
        "import torch.distributed as dist\n"
        "import repro_torch.sharding, repro_torch.launch.mesh, repro_torch.launch.specs\n"
        "import repro_torch.launch.dryrun, repro_torch.analysis.roofline\n"
        "print(dist.is_initialized())\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
