"""The program's platform contract: no accelerator-specific kernel
module anywhere, the compile cache in one fixed place, and chip_smoke.py
refusing to run where there is no GPU or no checkout around it."""

from __future__ import annotations

import os
import pkgutil
import shutil
import stat
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code_or_argv, env=None, cwd=REPO, timeout=300):
    argv = ([sys.executable, "-c", code_or_argv]
            if isinstance(code_or_argv, str) else code_or_argv)
    return subprocess.run(argv, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_no_module_imports_pallas():
    """Importing every module of the package, the bench and the smoke
    script pulls in no Pallas module."""
    import gnss_dsp

    mods = [m.name for m in pkgutil.walk_packages(gnss_dsp.__path__,
                                                  "gnss_dsp.")
            if not m.name.endswith("__main__")]
    code = ("import sys, importlib\n"
            f"for m in {mods!r} + ['bench', 'chip_smoke']:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if 'pallas' in m]\n"
            "print(len(sys.modules), bad)\n"
            "assert not bad, bad\n")
    r = _run(code, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-2000:]


def test_source_names_no_kernel_api():
    """No source file imports Pallas or reads a removed kernel switch."""
    words = ("experimental import pallas", "experimental.pallas",
             "_PALLAS", "NO_FUSED", "NO_V2P", "FUSED_PROBE", "TILE_PROBE")
    hits = []
    for root in ("gnss_dsp", "tools", "tests", "scripts"):
        for dirpath, _, files in os.walk(os.path.join(REPO, root)):
            for f in files:
                if f.endswith(".py") and f != os.path.basename(__file__):
                    text = open(os.path.join(dirpath, f)).read()
                    hits += [(f, w) for w in words if w in text]
    for f in ("bench.py", "chip_smoke.py", "__graft_entry__.py"):
        text = open(os.path.join(REPO, f)).read()
        hits += [(f, w) for w in words if w in text]
    assert not hits, hits


@pytest.mark.parametrize("env_dir", [False, True], ids=["default", "env"])
def test_compile_cache_placement(env_dir, tmp_path):
    """JAX_COMPILATION_CACHE_DIR is honoured and nothing else set;
    otherwise the cache sits at <checkout>/.cache/jax."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cc")
    r = _run("import jax\n"
             "from gnss_dsp.cli import enable_compilation_cache\n"
             "print(enable_compilation_cache())\n"
             "print(jax.config.jax_compilation_cache_dir)\n", env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    got, cfg = r.stdout.split()[-2:]
    want = (str(tmp_path / "cc") if env_dir
            else os.path.join(REPO, ".cache", "jax"))
    assert got == want and cfg == want, (got, cfg)


def _fake_smi(tmp_path):
    """A directory whose nvidia-smi reports one card."""
    d = tmp_path / "bin"
    d.mkdir()
    smi = d / "nvidia-smi"
    smi.write_text("#!/bin/sh\necho 'NVIDIA H100 80GB HBM3, 700.00 W'\n")
    smi.chmod(smi.stat().st_mode | stat.S_IXUSR)
    return str(d)


@pytest.mark.parametrize("how", ["no_nvidia_smi", "jax_on_cpu", "alone"])
def test_chip_smoke_refuses(how, tmp_path):
    """Without a GPU, or outside a checkout, chip_smoke.py exits non-zero
    and prints no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if how == "no_nvidia_smi":
        env["PATH"] = os.pathsep.join(
            p for p in env["PATH"].split(os.pathsep)
            if not os.path.exists(os.path.join(p, "nvidia-smi")))
    else:
        env["PATH"] = _fake_smi(tmp_path) + os.pathsep + env["PATH"]
    if how == "alone":
        cwd = str(tmp_path / "alone")
        os.makedirs(cwd)
        script = shutil.copy(script, cwd)
        env.pop("PYTHONPATH", None)
    r = _run([sys.executable, script, "--phases", "A"], env=env, cwd=cwd)
    assert r.returncode != 0, r.stdout
    assert '"ok"' not in r.stdout, r.stdout
