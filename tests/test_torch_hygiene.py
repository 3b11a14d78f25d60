"""The port stands alone: no JAX, flax, YAML or msgpack, and nothing of
the JAX package, in ``lanczosnet_torch``, ``chip_smoke.py`` or the
port's tools (``scripts/torch_*.py``, which import no JAX tool either).

The import check runs in a fresh interpreter: this test process has
imported JAX already (tests/conftest.py).
"""

import ast
import importlib
import subprocess
import tomllib
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "lanczosnet_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "yaml", "msgpack", "lanczosnet_tpu")
# modules the walk must find: the serving fronts, export, the reader of
# JAX checkpoints and the Jacobi eigensolver among them
EXPECTED = ("lanczosnet_torch.serve", "lanczosnet_torch.serve_http",
            "lanczosnet_torch.serve_native", "lanczosnet_torch.export",
            "lanczosnet_torch.train.flax_msgpack", "lanczosnet_torch.train.unported",
            "lanczosnet_torch.train.checkpoint", "lanczosnet_torch.ops.lanczos_cuda",
            "lanczosnet_torch.dryrun", "lanczosnet_torch.data.buckets",
            "lanczosnet_torch.data.native", "lanczosnet_torch.utils.profiling",
            "lanczosnet_torch.ops.jacobi", "lanczosnet_torch.utils.poison")


# the port's tools may not import the JAX side's measuring tools either
SCRIPT_FORBIDDEN = FORBIDDEN + ("bench", *sorted(
    p.stem for p in (REPO / "scripts").glob("*.py") if not p.stem.startswith("torch_")))


def port_sources() -> list[Path]:
    return (sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
            + sorted((REPO / "scripts").glob("torch_*.py")))


def test_importing_every_port_module_pulls_in_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import lanczosnet_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(lanczosnet_torch.__path__, 'lanczosnet_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        f"missing = sorted(set({EXPECTED!r}) - set(names))\n"
        "print(len(names), bad, missing)\n"
        "sys.exit(1 if bad or missing or len(names) < 10 else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_import_nothing_forbidden():
    offenders = []
    for path in port_sources():
        forbidden = SCRIPT_FORBIDDEN if path.parent.name == "scripts" else FORBIDDEN
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            offenders += [
                f"{path.relative_to(REPO)}:{node.lineno} {n}"
                for n in names if n.split(".")[0] in forbidden
            ]
    assert not offenders


def test_console_scripts_name_the_port_mains():
    """``[project.scripts]``: the JAX package's three entries as they were
    and the port's four beside them, each a callable main."""
    scripts = tomllib.loads((REPO / "pyproject.toml").read_text())["project"]["scripts"]
    assert {k: v for k, v in scripts.items() if "torch" not in k} == {
        "lanczosnet-run": "lanczosnet_tpu.cli:main",
        "lanczosnet-serve": "lanczosnet_tpu.serve_http:main",
        "lanczosnet-export": "lanczosnet_tpu.export:main"}
    port = {k: v for k, v in scripts.items() if "torch" in k}
    assert sorted(port) == ["lanczosnet-torch-dryrun", "lanczosnet-torch-export",
                            "lanczosnet-torch-run", "lanczosnet-torch-serve"]
    for target in port.values():
        module, name = target.split(":")
        assert module.startswith("lanczosnet_torch.")
        assert callable(getattr(importlib.import_module(module), name))
