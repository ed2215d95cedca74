"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the reference package ``repro``."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _banned(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _banned(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            if _banned(node.module):
                bad.append(node.module)
    assert not bad, f"{path}: imports {bad}"


def test_import_leaves_jax_and_repro_unloaded():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.data.tpch_udfs\n"
        "import repro_torch.kernels.relagg.relagg, repro_torch.fuse, repro_torch.cost\n"
        "import repro_torch.cost.router, repro_torch.persist, repro_torch.persist.keys\n"
        "import repro_torch.dist, repro_torch.dist.sharding, repro_torch.launch.mesh\n"
        "import repro_torch.train, repro_torch.train.checkpoint, repro_torch.train.elastic\n"
        "import repro_torch.train.straggler, repro_torch.data.pipeline\n"
        "import repro_torch.dist.compress, repro_torch.dist.activations\n"
        "import repro_torch.launch.train, repro_torch.models.convert\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.report, repro_torch.launch.roofline\n"
        "import repro_torch.kernels.flash_attention.ops, repro_torch.kernels.ssd_scan.ops\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "print(loaded)\n"
        "sys.exit(1 if loaded else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stdout + out.stderr
