"""The port's experiment scripts (``omr_a2s_multimodal_transformer_tpu_torch/tools/*.sh``): the seven r05 queue
scripts and ``run_experiments.sh``, checked without training anything.

- ``bash -n`` parses each script.
- No line names the JAX package or a root ``tools/*.py`` / ``tools/*.sh`` file: every step runs the port.
- Each script runs in a copy of the repository's layout under a temporary folder with a ``python`` on PATH that
  records every ``python -m omr_a2s_multimodal_transformer_tpu_torch.<mod> ...`` call and exits 0, and hands any
  other call (the gates' heredocs, ``python -c`` of ``synth_cfg``) to this interpreter: so the shell substitutes
  its own variables and loops, and the gates, which find no metrics there, take their extension branches. Every
  recorded call's flags then parse under ``<mod>``'s own argparser (its ``main`` run with argparse stopped right
  after a parse that succeeded); a module without one (``export_verify_imgs``) takes at most its one positional
  argument.
"""

import argparse
import importlib
import os
import re
import shutil
import stat
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = "omr_a2s_multimodal_transformer_tpu_torch"
TOOLS = ROOT / PKG / "tools"
SCRIPTS = [f"r05_{n}.sh" for n in ("cprime", "queue", "queue2", "queue3", "queue4", "queue5", "queue6")] + [
    "run_experiments.sh"]
# the JAX package's name not followed by _torch, or a path into the root tools/ (not the port's <PKG>/tools/)
FOREIGN = re.compile(r"omr_a2s_multimodal_transformer_tpu(?!_torch)|(?<![\w/])tools/\w+\.(?:py|sh)\b")
FS, RS = "\x1f", "\x1e"
SHIM = f"""#!/bin/sh
if [ "$1" = "-m" ]; then
  case "$2" in {PKG}.*) printf '%s{FS}' "$@" >> "$CALL_LOG"; printf '{RS}' >> "$CALL_LOG"; exit 0;; esac
fi
exec "$REAL_PYTHON" "$@"
"""


class _Parsed(Exception):
    pass


def test_every_script_is_there_and_parses_under_bash():
    for name in SCRIPTS:
        run = subprocess.run(["bash", "-n", str(TOOLS / name)], capture_output=True, text=True)
        assert run.returncode == 0, (name, run.stderr)


@pytest.mark.parametrize("name", SCRIPTS)
def test_no_script_line_names_the_jax_package_or_a_root_tool(name):
    bad = [(i, line) for i, line in enumerate((TOOLS / name).read_text().splitlines(), 1) if FOREIGN.search(line)]
    assert not bad, bad


def _run_all(tmp: Path) -> dict:
    """Each script run from a copy of the layout under tmp (all at once): name -> the module calls it made."""
    bin_dir = tmp / "bin"
    bin_dir.mkdir()
    shim = bin_dir / "python"
    shim.write_text(SHIM)
    shim.chmod(shim.stat().st_mode | stat.S_IEXEC)
    runs = {}
    for name in SCRIPTS:
        work = tmp / name
        tools = work / PKG / "tools"
        tools.mkdir(parents=True)
        shutil.copy(TOOLS / name, tools / name)
        if name == "r05_cprime.sh":  # it ends by running r05_queue6.sh
            shutil.copy(TOOLS / "r05_queue6.sh", tools / "r05_queue6.sh")
        env = dict(os.environ, PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}", CALL_LOG=str(work / "calls"),
                   REAL_PYTHON=sys.executable, PYTHONPATH=str(ROOT))
        runs[name] = subprocess.Popen(["bash", str(tools / name)], cwd=work, env=env, text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    out = {}
    for name, proc in runs.items():
        log, _ = proc.communicate(timeout=120)
        calls_file = tmp / name / "calls"
        calls = [c.split(FS)[:-1] for c in calls_file.read_text().split(RS)[:-1]] if calls_file.exists() else []
        out[name] = dict(rc=proc.returncode, log=log, calls=calls)
    return out


@pytest.fixture(scope="module")
def script_runs(tmp_path_factory):
    return _run_all(tmp_path_factory.mktemp("scripts"))


def _parses(module: str, argv: list) -> None:
    """argv parses under module's own argparser: its main(argv), stopped right after a parse that succeeded."""
    mod = importlib.import_module(module)
    if "parse_args" not in Path(mod.__file__).read_text():
        assert len(argv) <= 1, (module, argv)
        return
    real = argparse.ArgumentParser.parse_args

    def parse(self, args=None, namespace=None):
        raise _Parsed(real(self, args, namespace))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", parse)
        with pytest.raises(_Parsed):
            mod.main(argv)


@pytest.mark.parametrize("name", SCRIPTS)
def test_script_calls_parse_under_each_modules_own_flags(script_runs, name):
    run = script_runs[name]
    calls = run["calls"]
    assert run["rc"] == 0 and calls and all(c[0] == "-m" for c in calls), run["log"][-2000:]
    seen = set()
    for call in calls:
        key = tuple(call[1:])
        if key in seen:
            continue
        seen.add(key)
        _parses(call[1], list(call[2:]))
    modules = {c[1].rsplit(".", 1)[-1] for c in calls}
    if name == "run_experiments.sh":
        assert modules == {"train", "test", "sw_test", "weighted_test"}, modules
    else:
        assert "run_grid" in modules, modules
