"""The torch port stands alone: no file under areal_tpu_torch/, and not
chip_smoke.py, imports `jax` or anything of `areal_tpu`, and every port
module imports in a fresh interpreter where both are blocked, and so are
the packages the card's machine lacks (`yaml`, `optax`, `safetensors`,
`ml_dtypes`, `transformers`, `aiohttp`)."""

import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "areal_tpu_torch")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PORT):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


BLOCKED = ("jax", "jaxlib", "areal_tpu", "yaml", "optax", "safetensors", "ml_dtypes",
           "transformers", "aiohttp")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in BLOCKED


def test_no_port_file_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 10
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
                  and node.args and isinstance(node.args[0], ast.Constant)):
                names = [node.args[0].value]
            bad += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert not bad, bad


def test_every_port_module_imports_without_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "import areal_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(areal_tpu_torch.__path__, "
        "'areal_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        f"assert not [k for k in sys.modules if k.split('.')[0] in {BLOCKED!r} "
        "and sys.modules[k] is not None]\n"
        "print(len(mods))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip().splitlines()[-1]) >= 26
