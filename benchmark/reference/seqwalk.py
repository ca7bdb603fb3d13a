"""The reference C's per-sample phase recurrences, replayed exactly.

The reference advances each channel's code and carrier phase by repeated
float64 addition inside its sample loop (gps.c:2789 ``code_phase +=
f_code*delt`` with the 1023-chip wrap and the data-bit cascade;
gps.c:2820-2826 ``carr_phase += f_carr*delt`` with a one-step wrap into
[0, 1)). Between two wraps that is one running sum, and
``np.add.accumulate`` computes a running sum strictly left to right with
one IEEE rounding per addition, which is the same sequence of values.
The walk runs the sum a chunk at a time, up to the first wrap, applies
the wrap with the same float64 operation as the C code, and goes on.
"""

from __future__ import annotations

import numpy as np

CA_LEN = 1023.0


def _walk(x0: float, d: float, n: int, code: bool) -> tuple[np.ndarray,
                                                            np.ndarray]:
    """Values x[0..n] (x[k] is the state after k steps) and a mask of the
    steps that wrapped."""
    out = np.empty(n + 1, dtype=np.float64)
    wrapped = np.zeros(n + 1, dtype=bool)
    out[0] = x0
    span = CA_LEN if code else 1.0
    chunk = n if d == 0.0 else min(n, int(span / abs(d)) + 2)
    pos, x = 0, float(x0)
    seg = np.empty(chunk + 1, dtype=np.float64)
    while pos < n:
        length = min(n - pos, chunk)
        s = seg[:length + 1]
        s[0] = x
        s[1:] = d
        np.add.accumulate(s, out=s)
        body = s[1:]
        if code:
            hit = np.flatnonzero(body >= CA_LEN)
        else:
            hit = np.flatnonzero((body >= 1.0) | (body < 0.0))
        if hit.size == 0:
            out[pos + 1:pos + length + 1] = body
            x = float(s[length])
            pos += length
            continue
        j = int(hit[0]) + 1  # steps to the first wrap
        out[pos + 1:pos + j] = s[1:j]
        v = float(s[j])
        if code:
            v = v - CA_LEN
        elif v >= 1.0:
            v = v - 1.0
        else:
            v = v + 1.0
        out[pos + j] = v
        wrapped[pos + j] = True
        x = v
        pos += j
    return out, wrapped


def code_walk(cp0: float, dc: float, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Code phase (chips) used at samples 0..n, and the number of 1023-chip
    wraps before each."""
    vals, wrapped = _walk(cp0, dc, n, code=True)
    return vals, np.cumsum(wrapped)


def carrier_walk(c0: float, dp: float, n: int) -> np.ndarray:
    """Carrier phase (cycles) used at samples 0..n."""
    return _walk(c0, dp, n, code=False)[0]


def carrier_end(c0: float, dp: float, n: int) -> float:
    """The carrier phase after ``n`` samples: the next block's start."""
    return float(carrier_walk(c0, dp, n)[n])
