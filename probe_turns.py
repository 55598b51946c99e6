"""What the root probes share: copies of the port beside this checkout's
scripts, their kernels built in parallel, and a process per part, run in
turns and collected as JSON, so that two versions of a kernel are compared
within one call on one card.

A probe imports this module and runs itself with ``--child NAME --out-dir
D`` in each root; the child writes its result to D/NAME.json.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PORT = "omr_a2s_multimodal_transformer_tpu_torch"
SCRIPTS = ("chip_smoke.py", "probe_turns.py")


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def copy_port(src: Path, root: Path, probe: str) -> Path:
    """root: the port of the checkout at src beside this checkout's
    chip_smoke.py, this module and the probe `probe` (a file name here)."""
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(src / PORT, root / PORT, ignore=shutil.ignore_patterns("__pycache__"))
    for script in (*SCRIPTS, probe):
        shutil.copy(ROOT / script, root)
    return root


def build(libs: dict) -> None:
    """Build each root's kernels ({root: [library names]}), all at once."""
    code = f"import sys; from {PORT}.ops import cuda_build; cuda_build.build_all(sys.argv[1:])"
    procs = [subprocess.Popen([sys.executable, "-c", code, *names], cwd=root) for root, names in libs.items()]
    if any([p.wait() for p in procs]):
        raise RuntimeError("a build failed")


def run_in_turns(probe: str, order: list, roots: dict, out_dir: Path, timeout: int = 900, args: tuple = ()) -> list:
    """Run `probe` --child NAME [args] in roots[NAME] for each NAME of order,
    one after another; the children's results, in order."""
    results = []
    for name in order:
        proc = subprocess.run([sys.executable, str(roots[name] / probe), "--child", name, "--out-dir", str(out_dir),
                               *args], cwd=roots[name], timeout=timeout)
        if proc.returncode:
            raise RuntimeError(f"{name}: exit code {proc.returncode}")
        results.append(json.loads((out_dir / f"{name}.json").read_text()))
    return results
