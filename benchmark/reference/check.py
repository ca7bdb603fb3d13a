"""The comparison that decides ``correct``.

Given the generated inputs of each receiver and what the program handed
out (the number of blocks written to its sink, a checksum of each block
that the harness chose for the check before the run, and the block-start
carrier phase of every plan), it counts:

``blocks_mismatched``
    chosen blocks whose bytes differ from the reference's (for a paced
    stream, also as the receiver on the other end of the socket read
    them). Exact: limit 0.
``phases_mismatched``
    block-start carrier phases that break the reference C's semantics:
    a freshly allocated channel's phase must equal the allocation value
    exactly; every other phase must lie within the proven bound of the
    reference's closed-form chain (``planner``); and at sampled blocks
    (the first block, and up to ``steps`` more drawn from the seed) the
    next block's phase must equal the sequential float64 replay of this
    block's samples (``seqwalk``) exactly. Exact: limit 0.

The reference synthesizes every block from the program's block-start
phases (it cannot replay the whole sequential chain in the time of a
run); the phase checks above hold those phases to the reference.

In the port's closed form (a receiver with ``parity_exact=False``) the
reference chains the phases itself, every block-start phase must equal
its own exactly, and the bytes are the fixed-point closed form of its own
plans (``synth.fixed_point_bytes``).

``control=True`` (closed form) puts the reference itself in the
program's place at a precision below the configuration's: the closed
form in float32, phases rounded to float32. The check must fail it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..fingerprint import fingerprints
from .planner import Planner
from .seqwalk import carrier_end
from .synth import fixed_point_bytes, synth_bytes

BATCH = 32


def _compare_bytes(out, positions, handed, received, state):
    """``positions`` are 0-based; ``handed`` is keyed by block index."""
    for b, want in zip(positions, fingerprints(out)):
        b = int(b)
        wrong = handed.get(b + 1) != want
        if received is not None:
            wrong |= b >= len(received) or received[b] != want
        if wrong:
            state["bad"] += 1
            if state["first"] is None:
                state["first"] = b + 1


def _control_bytes(plans, picked, device) -> dict:
    """The reference in the program's place, in float32: its phases
    rounded to float32 and the closed form evaluated in float32."""
    handed = {}
    for lo in range(0, picked.size, BATCH):
        idx = picked[lo:lo + BATCH]
        starts = np.stack([plans[b].carr_phase for b in idx])
        out = fixed_point_bytes([plans[b] for b in idx],
                                starts.astype(np.float32).astype(np.float64),
                                device, dtype=torch.float32)
        handed.update(zip((int(b) + 1 for b in idx), fingerprints(out)))
    return handed


def _timed(times: dict, stage: str, t0: float) -> float:
    now = time.perf_counter()
    times[stage] = times.get(stage, 0.0) + now - t0
    return now


def check_closed_form(plans, prog, handed, received, device, times: dict,
                      control: bool = False) -> dict:
    """The port's closed form: exact phases, exact bytes."""
    picked = np.array(sorted(handed), dtype=np.int64) - 1
    if control:
        prog = np.stack([p.carr_phase for p in plans]).astype(
            np.float32).astype(np.float64)
        handed, received = _control_bytes(plans, picked, device), None
    bad_phase = 0
    for b, p in enumerate(plans):
        on = p.active
        bad_phase += int(np.sum(~(prog[b][on] == p.carr_phase[on])))
    state = {"bad": 0, "first": None}
    for lo in range(0, picked.size, BATCH):
        t0 = time.perf_counter()
        idx = picked[lo:lo + BATCH]
        chunk = [plans[b] for b in idx]
        out = fixed_point_bytes(chunk, np.stack([p.carr_phase
                                                 for p in chunk]), device)
        t0 = _timed(times, "synth", t0)
        _compare_bytes(out, idx, handed, received, state)
        _timed(times, "sums", t0)
    return dict(blocks=len(plans), compared=int(picked.size),
                blocks_mismatched=state["bad"], phases_mismatched=bad_phase,
                steps=0, flagged=0, first_bad_block=state["first"])


def check_receiver(rx, phases: dict, written: int, handed: dict,
                   received=None, *, seed: int, device: str, steps: int = 16,
                   control: bool = False, times: dict | None = None) -> dict:
    """The numbers of one receiver; ``times`` gathers the seconds spent
    by stage."""
    times = {} if times is None else times
    M = written
    t0 = time.perf_counter()
    planner = Planner(rx)
    plans = [planner.next_plan() for _ in range(M)]
    _timed(times, "plan", t0)
    if not plans:
        return dict(blocks=0, compared=0, blocks_mismatched=0,
                    phases_mismatched=0, steps=0, flagged=0,
                    first_bad_block=None)
    N, delt = plans[0].num_samples, plans[0].delt
    C = plans[0].active.size
    prog = np.full((M, C), np.nan)
    for b in range(M):
        if b + 1 in phases:
            prog[b] = phases[b + 1]
    rng = np.random.default_rng([int(seed) % 2**63, 0x5EED])
    if not rx.parity_exact:
        return check_closed_form(plans, prog, handed, received, device,
                                 times, control)

    # the chain, against the closed form within the proven bound
    e_blk = (N + 64) * 2.0**-53 + 2.0**-40
    bad_phase = 0
    for b, p in enumerate(plans):
        on = p.active
        exact = on & p.fresh
        bad_phase += int(np.sum(prog[b][exact] != p.carr_phase[exact]))
        rest = on & ~p.fresh
        d = prog[b][rest] - p.carr_phase[rest]
        d = d - np.round(d)
        bad_phase += int(np.sum(~(np.abs(d) <= p.since[rest] * e_blk)))

    # sampled chain steps, replayed sample by sample
    t0 = time.perf_counter()
    picks = {0}
    if M > 2:
        picks |= set(int(x) for x in rng.choice(
            np.arange(1, M - 1), size=min(steps, M - 2), replace=False))
    n_steps = 0
    for b in sorted(picks):
        if b + 1 >= M:
            continue
        p, q = plans[b], plans[b + 1]
        for c in np.flatnonzero(p.active & q.active & ~q.fresh):
            end = carrier_end(prog[b, c], p.f_carr[c] * delt, N)
            bad_phase += int(end != prog[b + 1, c])
            n_steps += 1

    _timed(times, "steps", t0)
    # the chosen blocks' bytes
    state = {"bad": 0, "first": None}
    flagged = 0
    start = np.where(np.isnan(prog), 0.0, prog)
    picked = np.array(sorted(handed), dtype=np.int64) - 1
    for lo in range(0, picked.size, BATCH):
        idx = picked[lo:lo + BATCH]
        t0 = time.perf_counter()
        out, nf = synth_bytes([plans[b] for b in idx], start[idx], device)
        t0 = _timed(times, "synth", t0)
        flagged += nf
        _compare_bytes(out, idx, handed, received, state)
        _timed(times, "sums", t0)
    return dict(blocks=M, compared=int(picked.size),
                blocks_mismatched=state["bad"],
                phases_mismatched=bad_phase, steps=n_steps,
                flagged=flagged, first_bad_block=state["first"])


def check_all(receivers, records, *, seed: int, device: str,
              control: bool = False) -> dict:
    """Sum of ``check_receiver`` over the members of a deployment;
    ``records`` holds (phases, blocks written, checksums, checksums the
    stream's receiver read) per member."""
    total: dict = {}
    times: dict = {}
    for m, (rx, (phases, written, handed, received)) in enumerate(
            zip(receivers, records)):
        r = check_receiver(rx, phases, written, handed, received,
                           seed=int(seed) * 64 + m, device=device,
                           control=control, times=times)
        for k, v in r.items():
            if k == "first_bad_block":
                if v is not None and "first_bad" not in total:
                    total["first_bad"] = f"member {m} block {v}"
            else:
                total[k] = total.get(k, 0) + v
    total["check_parts_s"] = times
    return total
