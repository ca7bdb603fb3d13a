"""Typed runtime configuration for the simulator.

One config object covers everything that was split across argp options,
``simulator_t`` runtime state and compile-time #defines in the reference
(help.h:20-53, gps-sim.h:56-85, gps.h:17-21): sample rate, carrier-phase
mode, sample format, sink, scenario timing, motion, iono/almanac toggles,
oscillator ppb error, and the device execution mode.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from .core.constants import DEFAULT_TX_SAMPLERATE, MAX_CHAN
from .core.gpstime import DateTime


class SampleFormat(enum.Enum):
    SC08 = 8  # int8, accumulator >> 4 (gps.c:2844)
    SC16 = 16  # int16 raw accumulator


class CarrierMode(enum.Enum):
    FLOAT = "float"  # double carrier phase (FLOAT_CARR_PHASE, gps.h:17)
    INT_NCO = "int_nco"  # 9.16 fixed-point NCO (gps.h:221-223) — exact & fast


class SynthBackend(enum.Enum):
    NUMPY = "numpy"  # float64 host reference path (parity oracle)
    NATIVE = "native"  # C++ sequential hot loop (fast host path, bit-exact)
    CUDA = "cuda"  # hand-written CUDA kernel (ops/synth_cuda.py)
    TORCH = "torch"  # plain PyTorch version of the same kernel


@dataclass
class LocationConfig:
    lat: float = 35.681298
    lon: float = 139.766247
    height: float = 10.0


@dataclass
class TargetConfig:
    distance: float = 0.0
    bearing_millideg: float = 0.0  # bearing*1000 (gps-sim.c:148)
    height: float = 0.0
    valid: bool = False


@dataclass
class SimConfig:
    # Signal plan
    sample_rate: int = DEFAULT_TX_SAMPLERATE
    sample_format: SampleFormat = SampleFormat.SC08
    carrier_mode: CarrierMode = CarrierMode.FLOAT
    num_channels: int = MAX_CHAN

    # Scenario
    nav_file: str | None = None
    rinex_version: int = 2
    start: DateTime | None = None  # None → first toc in the nav file
    time_overwrite: bool = False  # "--start now" relocation
    duration_sec: float = 300.0
    location: LocationConfig = field(default_factory=LocationConfig)
    target: TargetConfig = field(default_factory=TargetConfig)
    motion_file: str | None = None
    interactive: bool = False

    # Models
    ionosphere_enable: bool = True
    almanac_enable: bool = True
    almanac_file: str | None = None
    ppb: int = 0  # oscillator error; scales synthesis rate/frequency
    pluto_gain_boost: bool = False  # reference doubles gain for Pluto (gps.c:2759)
    # Optional receiver-QA AWGN on the quantized output (noise.py);
    # 0.0 = off = the reference's clean-signal semantics, bit-exact.
    noise_std_lsb: float = 0.0
    noise_seed: int = 0

    # Data fetch (reference --use-ftp / --station, gps.c:2388-2467)
    use_ftp: bool = False
    station_id: str | None = None

    # Hardware sink parameters (reference -g/-a/-U/-N)
    tx_gain: int = 0
    tx_amplifier: bool = False
    pluto_uri: str | None = None
    # None = try a local (USB) IIO context first, then pluto.local — the
    # reference's default precedence (gps-sim.c:204, sdr_pluto.c:140-156).
    pluto_hostname: str | None = None

    # Checkpoint / profiling / metrics
    checkpoint_file: str | None = None
    profile_dir: str | None = None
    metrics_file: str | None = None  # JSONL, one record per 30 s of signal

    # Execution
    backend: SynthBackend = SynthBackend.CUDA
    # Torch device for the cuda/torch backends. "cuda" without a card
    # raises; the CPU runs only when asked for explicitly.
    device: str = "cuda"
    parity_exact: bool = True  # mirror C quirks (xyz[0] realloc etc.)
    verbose: bool = False
    # Blocks per device dispatch on the cuda/torch path; device compute of
    # batch k+1 overlaps D2H + sink of batch k. A realtime run caps it at
    # half the FIFO depth (runner.dispatch_window).
    dispatch_blocks: int = 25

    # Sink
    sink: str = "iqfile"
    out_file: str = "iqdata.bin"
    fifo_depth: int = 8
    tcp_addr: str = "127.0.0.1:4729"  # --radio tcp destination
    realtime: bool = False  # pace output at wall-clock rate (TX use case)
    # Sustained sub-1x realtime deficit response (runner.RealtimeSupervisor):
    # "failover" switches synthesis to the native sequential engine with a
    # logged event; "fail" raises an attributed error; "warn" logs and
    # keeps counting (the reference's behavior, fifo.c:97-148, plus
    # attribution).
    realtime_policy: str = "failover"
    # After a failover, probe the device path every this many seconds of
    # written signal (a shadow window dispatched in the background while
    # the native engine keeps the stream on time) and fail BACK to the
    # batched device pipeline once a probe completes a full window at
    # >= 2x realtime (runner.DeviceProbe). 0 disables failback — the
    # pre-r5 one-way behavior.
    failback_probe_sec: float = 10.0

    @property
    def samples_per_epoch(self) -> int:
        # NUM_IQ_SAMPLES = rate / 10 (sdr.h:26); epoch is fixed at 0.1 s.
        return self.sample_rate // 10

    @property
    def num_epochs(self) -> int:
        # Round like the reference's CLI (gps-sim.c:140: (int)(d*10+0.5))
        # so fractional durations agree — truncation would drop an epoch
        # for e.g. duration_sec=0.55.
        return int(self.duration_sec * 10.0 + 0.5)
