"""Rules of the PyTorch/CUDA package.

* Nothing in ``gpssim_tpu_torch/`` or ``chip_smoke.py`` imports JAX or the
  JAX package (checked on the source, and by importing every module of the
  package with both blocked).
* ``device="cuda"`` without a card raises; it never runs on the CPU.
* The kernel wrapper runs its plain version only for CPU tensors, without
  building the kernel.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "gpssim_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "gpssim_tpu")


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(os.path.relpath(f, REPO) for f in files)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"):
            yield from (a.value for a in node.args[:1]
                        if isinstance(a, ast.Constant))


@pytest.mark.parametrize("rel", _port_sources())
def test_no_jax_imports(rel):
    bad = [m for m in _imported_modules(os.path.join(REPO, rel))
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{rel} imports {bad}"


def test_package_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'jaxlib', 'gpssim_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import gpssim_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    gpssim_tpu_torch.__path__, 'gpssim_tpu_torch.')]\n"
        "for m in mods:\n"
        "    if not m.endswith('.__main__'):  # that one runs the CLI\n"
        "        importlib.import_module(m)\n"
        "import chip_smoke\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'gpssim_tpu.'))\n"
        "               for k in sys.modules if sys.modules[k] is not None)\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.split()[-1]) >= 30


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_cuda_device_without_card_raises(fixtures_dir, tmp_path, monkeypatch):
    from gpssim_tpu_torch import cli, runner
    from gpssim_tpu_torch.config import SimConfig, SynthBackend

    _no_card(monkeypatch)
    for backend in (SynthBackend.CUDA, SynthBackend.TORCH):
        for window in (25, 1):
            cfg = SimConfig(nav_file=f"{fixtures_dir}/brdc_test.22n",
                            duration_sec=0.3, almanac_enable=False,
                            backend=backend, dispatch_blocks=window,
                            sink="iqfile", out_file=str(tmp_path / "x.bin"))
            assert cfg.device == "cuda"  # the default
            with pytest.raises(RuntimeError, match="no CUDA device"):
                runner.run_simulation(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-e", f"{fixtures_dir}/brdc_test.22n", "-d", "0.3",
                  "-r", "iqfile", "--out-file", str(tmp_path / "y.bin")])
    assert not (tmp_path / "x.bin").exists()


def test_chip_smoke_refuses_without_card(monkeypatch, capsys):
    import chip_smoke

    _no_card(monkeypatch)
    assert chip_smoke.main() != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out and "kernels" not in out


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    it exits non-zero and prints no result."""
    src = os.path.join(REPO, "chip_smoke.py")
    dst = tmp_path / "chip_smoke.py"
    dst.write_text(open(src).read())
    out = subprocess.run([sys.executable, str(dst)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_wrapper_on_cpu_runs_plain_version_without_build(monkeypatch):
    from gpssim_tpu_torch.ops import _build, synth_cuda
    from gpssim_tpu_torch.ops.args import args_from_arrays, to_device
    from gpssim_tpu_torch.ops.synth_torch import synth_blocks_batch_torch

    def no_build(*a, **k):
        raise AssertionError("the CPU path must not build the kernel")

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(synth_cuda, "load", no_build)
    rng = np.random.default_rng(2)
    C = 8
    a = args_from_arrays(
        np.ones(C, bool), rng.uniform(0, 1023, C), np.full(C, 1.023e6),
        rng.uniform(0, 1, C), rng.uniform(-5000, 5000, C),
        np.zeros(C, np.int64), np.zeros(C, np.int64), rng.uniform(0.5, 1, C),
        rng.integers(0, 29, C), rng.integers(0, 19, C),
        rng.integers(0, 19, C), rng.integers(1, 33, C),
        (rng.integers(0, 1 << 30, (C, 60)).astype(np.uint32) << 2),
        6_000, 1 / 3e6,
    )
    args = to_device({k: np.asarray(v)[None] for k, v in a.items()}, "cpu")
    before = synth_cuda.synth_blocks_batch_cuda.launches
    got = synth_cuda.synth_blocks_batch_cuda(args, n_rows=47,
                                             num_samples=6_000)
    want = synth_blocks_batch_torch(args, n_rows=47, num_samples=6_000)
    assert torch.equal(got, want)
    # CPU calls are not kernel launches
    assert synth_cuda.synth_blocks_batch_cuda.launches == before


def test_nvcc_missing_raises(monkeypatch):
    """No compiler means the kernel cannot be built: that raises."""
    from gpssim_tpu_torch.ops import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
