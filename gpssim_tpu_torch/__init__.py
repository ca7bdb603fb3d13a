"""gpssim_tpu_torch — the GPS L1 C/A signal synthesizer on PyTorch and CUDA.

The port of ``gpssim_tpu`` (JAX/Pallas on a TPU) to an NVIDIA H100: the
same host-side float64 orbital mechanics and nav-message construction
(own copies of the JAX-free modules) feed per-0.1 s block parameters to a
hand-written CUDA kernel that synthesizes a window of blocks per launch,
byte for byte the output of the JAX package.
"""

__version__ = "0.1.0"

from .config import (  # noqa: F401
    CarrierMode,
    LocationConfig,
    SampleFormat,
    SimConfig,
    SynthBackend,
    TargetConfig,
)

__all__ = [
    "CarrierMode", "LocationConfig", "SampleFormat", "SimConfig",
    "SynthBackend", "TargetConfig", "Simulation", "run_simulation",
    "run_app", "save_checkpoint", "load_checkpoint",
]


def __getattr__(name):  # lazy: keep `import gpssim_tpu_torch` light
    if name == "Simulation":
        from .scenario import Simulation

        return Simulation
    if name == "run_simulation":
        from .runner import run_simulation

        return run_simulation
    if name == "run_app":
        from .app import run_app

        return run_app
    if name in ("save_checkpoint", "load_checkpoint"):
        from . import checkpoint

        return getattr(checkpoint, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
