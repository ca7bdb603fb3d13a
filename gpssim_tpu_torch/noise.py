"""Optional deterministic AWGN on the quantized output stream.

The reference emits a noise-free signal (its hot loop sums pure channel
contributions, gps.c:2767-2836) — fine for TX through real RF hardware,
where the channel adds noise, but unrealistically clean for the
receiver-farm / software-QA use cases this framework adds (fleet.py,
receiver.py). This stage adds zero-mean Gaussian noise in output-LSB
units AFTER quantization, so:

- ``noise_std_lsb == 0`` (the default) leaves the bit-exact parity path
  untouched — not a single instruction changes;
- the device kernels stay clean-signal and bit-exact; noise is a host
  post-stage on the already-quantized int8/int16 stream (quantization
  noise is part of any real front-end's noise budget at these levels);
- the draw is COUNTER-BASED: Philox keyed by (seed, stream, block index)
  — so the same scenario produces the same noisy stream regardless of
  dispatch batching, checkpoint/resume split, or fleet interleaving
  (asserted in tests/test_noise.py).
"""

from __future__ import annotations

import numpy as np


def apply_awgn(
    block: np.ndarray,
    bits: int,
    std_lsb: float,
    seed: int,
    stream: int,
    block_index: int,
) -> np.ndarray:
    """Return ``block`` plus rounded N(0, std_lsb²) noise, clipped to the
    output dtype's range. ``block`` is the interleaved quantized IQ array
    of one 0.1 s block; it is not modified."""
    if std_lsb <= 0.0:
        return block
    # Philox counter word 0 advances as values are drawn (little-endian),
    # so the (block, stream) coordinates live in the high words — distinct
    # blocks/streams can never overlap draw ranges.
    rng = np.random.Generator(
        np.random.Philox(
            key=[seed & 0xFFFFFFFFFFFFFFFF, 0x6770737E],  # 'gps~' tag
            counter=[0, block_index, stream, 0],
        )
    )
    # float32 draws + integer-domain add: ~2x the throughput of an f64
    # formulation and statistically identical (the realization itself is
    # versioned by this implementation, not a compatibility contract —
    # only determinism for a given build is promised).
    n = rng.standard_normal(block.shape[0], dtype=np.float32)
    n *= std_lsb
    np.rint(n, out=n)
    noisy = n.astype(np.int32)
    noisy += block
    if bits == 8:
        lo, hi, dtype = -128, 127, np.int8
    else:
        lo, hi, dtype = -32768, 32767, np.int16
    np.clip(noisy, lo, hi, out=noisy)
    return noisy.astype(dtype)
